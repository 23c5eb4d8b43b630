"""Compatibility helpers for migrating from reference FALCON runs.

falcon_tpu_torch has no generated bash, Dazzler databases or HPC.daligner job
plans of its own -- but users coming from the reference often have run
trees, DBstats captures and option strings produced by those tools.  This
package provides exact re-implementations of the reference's pure parsing
functions (falcon_kit/functional.py) so such artifacts can be inspected
and adopted (see mains.hgap_adapt).
"""
