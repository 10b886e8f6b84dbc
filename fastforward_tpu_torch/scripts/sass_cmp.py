"""Compare the SASS of the port's CUDA kernels between two checkouts.

    python3 fastforward_tpu_torch/scripts/sass_cmp.py OTHER [SOURCE ...]

Builds ``csrc/<SOURCE>.cu`` (default: every source of ``_build.SOURCES``)
of this checkout and of the checkout at OTHER with the build's own nvcc
command (``_build.NVCC_FLAGS``), one nvcc each, all in parallel, into
``build/sass_cmp/``, and disassembles both with cuobjdump. For every kernel
it prints its instruction count in each and whether its instructions
(addresses and encodings dropped) are the same: "same", "differs", "only
here" or "only there" (with ", same code as a kernel only there" where a
renamed kernel kept its code). Exits 1 where a kernel that both have
differs, so an instance that a change must leave alone can be held to its
SASS. Needs the CUDA toolkit, not a card.
"""

import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from fastforward_tpu_torch.kernels import _build  # noqa: E402

_INST = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _start(root: Path, name: str, out: Path) -> subprocess.Popen:
    csrc = root / "fastforward_tpu_torch" / "csrc"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
           str(csrc / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def kernels(lib: Path) -> dict:
    """{mangled kernel name: its instructions} of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = []
            continue
        m = _INST.search(line)
        if m and name is not None:
            found[name].append(m.group(1))
    return found


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other, names = Path(argv[0]).resolve(), argv[1:] or list(_build.SOURCES)
    out_dir = ROOT / "build" / "sass_cmp"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        for tag, root in (("here", ROOT), ("there", other)):
            lib = out_dir / f"{tag}_{name}.so"
            procs[tag, name] = (_start(root, name, lib), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {key}:\n{log}", file=sys.stderr)
            return 2
        libs[key] = lib
    differ = 0
    for name in names:
        here, there = kernels(libs["here", name]), kernels(libs["there", name])
        # code of the kernels only one side has (a template argument added
        # renames a kernel whose code stays)
        moved = {side: {tuple(v) for k, v in a.items() if k not in b}
                 for side, a, b in (("here", here, there), ("there", there, here))}
        for fn in sorted(set(here) | set(there)):
            a, b = here.get(fn), there.get(fn)
            if a is None or b is None:
                side, other = ("here", "there") if b is None else ("there", "here")
                same = tuple(a or b) in moved[other]
                verdict = f"only {side}" + (f", same code as a kernel only {other}" if same else "")
            else:
                verdict = "same" if a == b else "differs"
                differ += a != b
            digest = hashlib.sha1("\n".join(a or b).encode()).hexdigest()[:10]
            print(f"{name} | {verdict} | {len(a or [])} {len(b or [])} {digest} {fn}")
    print(f"sass_cmp: {differ} kernel(s) in both checkouts differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
