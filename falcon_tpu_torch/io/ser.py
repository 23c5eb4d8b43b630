"""Extension-dispatched (de)serialization for small pipeline artifacts.

Parity surface for the reference's falcon_kit/io.py:89-116: config
snapshots, split descriptions and reports are written as .json (always
available) or .msgpack (only if the optional dependency is installed --
gated, never required).  Writes are tmp+rename for crash atomicity, the
same idempotence philosophy as the reference's task re-run model.
"""
import json
import os


def _dump_json(obj, f):
    json.dump(obj, f, indent=2, separators=(",", ": "), sort_keys=True)
    f.write("\n")


def serialize(fn, obj):
    """Write obj to fn by extension (.json / .msgpack)."""
    tmp = fn + ".tmp"
    if fn.endswith(".json"):
        with open(tmp, "w") as f:
            _dump_json(obj, f)
    elif fn.endswith(".msgpack"):
        import msgpack  # optional; gated like the reference
        with open(tmp, "wb") as f:
            f.write(msgpack.dumps(obj))
    else:
        raise ValueError("Unknown serialization format: %r" % fn)
    os.replace(tmp, fn)


def deserialize(fn):
    """Read obj from fn by extension (.json / .msgpack)."""
    if fn.endswith(".json"):
        with open(fn) as f:
            return json.load(f)
    if fn.endswith(".msgpack"):
        import msgpack
        with open(fn, "rb") as f:
            return msgpack.loads(f.read())
    raise ValueError("Unknown serialization format: %r" % fn)
