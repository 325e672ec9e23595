#!/usr/bin/env python3
"""Compare the SASS of two builds of one CUDA source, kernel by kernel:

    python3 scripts/compare_sass.py A.so B.so

Each library is read with ``cuobjdump -sass``; kernel names are
demangled with ``cu++filt`` (the anonymous namespace's per-file hash
drops out), and each kernel's instructions are compared without their
addresses and encodings.  Prints one line per kernel that differs or is
in one library only, then the count of identical kernels.  Exits 0 when
every kernel is identical, else 1.  Needs the CUDA toolkit's
``cuobjdump`` and ``cu++filt`` on PATH; build the two libraries with the
same flags (``arcticinference_tpu_torch.ops.cuda.build.NVCC_FLAGS``).
A refactor that leaves every kernel identical cannot move its times.
"""

import re
import subprocess
import sys


def kernels(path: str) -> dict[str, list[str]]:
    sass = subprocess.run(["cuobjdump", "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    found: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;?\s*/\*", line)
        if name and m:
            found[name].append(m.group(1))
    names = subprocess.run(["cu++filt"], input="\n".join(found), text=True,
                           capture_output=True, check=True).stdout
    return dict(zip(names.splitlines(), found.values()))


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = kernels(sys.argv[1]), kernels(sys.argv[2])
    names = sorted(set(a) | set(b))
    same = 0
    for name in names:
        if name not in a or name not in b:
            print(f"only in {'B' if name not in a else 'A'}: {name}")
        elif a[name] == b[name]:
            same += 1
        else:
            ia, ib = a[name], b[name]
            moved = sum(x != y for x, y in zip(ia, ib)) + abs(len(ia) - len(ib))
            print(f"differs: {name}: {len(ia)} -> {len(ib)} instructions, "
                  f"{moved} positions differ")
    print(f"{same} of {len(names)} kernels identical")
    return 0 if same == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
