"""The port imports torch and never JAX or the JAX package.

Every module of `fastforward_tpu_torch` is imported in a fresh Python
process; afterwards neither ``jax`` nor any ``fastforward_tpu.`` module may
be loaded there.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import fastforward_tpu_torch

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import fastforward_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fastforward_tpu_torch.__path__,
                                               "fastforward_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "fastforward_tpu"
                or m.startswith("fastforward_tpu."))
print(json.dumps({"modules": names, "forbidden": loaded}))
"""


def test_port_modules_import_no_jax():
    # GIVEN every module of the port
    expected = sorted(m.name for m in pkgutil.walk_packages(
        fastforward_tpu_torch.__path__, "fastforward_tpu_torch."))
    for name in ("serving.stacked", "serving.sampling", "serving.paged", "serving.batching",
                 "kernels.paged_attention", "kernels.matmul"):
        assert f"fastforward_tpu_torch.{name}" in expected
    # WHEN all are imported in a fresh interpreter
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    # THEN each imported, and no JAX module was loaded
    assert sorted(result["modules"]) == expected
    assert result["forbidden"] == []
