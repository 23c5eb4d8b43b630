"""fc_run equivalent: the whole pipeline from a [General] cfg.

reference: falcon_kit/mains/run1.py (fc_run console script)."""
import sys

from ..pipeline.driver import main


if __name__ == "__main__":
    sys.exit(main())
