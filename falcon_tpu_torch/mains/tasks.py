"""`falcon-task` — pbsmrtpipe-style task entry points.

Reference: falcon_kit/mains/tasks.py (the only task is make-fofn-abs,
which copies a file-of-filenames expanding relative paths against the
directory of the INPUT fofn — falcon_kit/util/system.py:84-92).
"""
import os
import sys


def make_fofn_abs(i_fofn_fn, o_fofn_fn):
    """Copy i_fofn to o_fofn with relative paths made absolute against
    the directory of i_fofn (reference util/system.py:72-92)."""
    i_abs = os.path.abspath(i_fofn_fn)
    o_abs = os.path.abspath(o_fofn_fn)
    if i_abs == o_abs:
        raise ValueError("input and output fofn are the same file: %r"
                         % i_abs)
    idir = os.path.dirname(os.path.realpath(i_fofn_fn))
    with open(i_fofn_fn) as ifs, open(o_fofn_fn, "w") as ofs:
        for line in ifs.read().split():
            fn = line.strip()
            if not fn:
                continue
            if not os.path.isabs(fn):
                fn = os.path.abspath(os.path.join(idir, fn))
            ofs.write(fn + "\n")


def _help():
    print("""\
Usage:
    falcon-task [task] <[task-args]>

tasks:
    make-fofn-abs <input.fofn> <output.fofn>
""")
    return 2


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    if len(argv) < 2 or argv[1].startswith("-"):
        return _help()
    task = argv[1]
    tasks = {
        "make-fofn-abs": make_fofn_abs,
    }
    if task not in tasks:
        return _help()
    tasks[task](*argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
