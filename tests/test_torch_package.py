"""Package-level properties of the port (snark_verifier_tpu_torch): it
imports no JAX, its kernel wrappers route by device and validate their
inputs, the kernel build goes to the ignored build directory, and
chip_smoke.py refuses to run without a CUDA card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import convert
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import curve_cuda as CK
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import field_cuda as FK
from snark_verifier_tpu_torch.ops import msm_cuda as MK

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "snark_verifier_tpu_torch"

BLOCK_JAX = """
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import snark_verifier_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules
print(len(names))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX], capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15  # every module of the package


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA device visible: non-zero exit and no result line; copied
    alone into an empty directory it must fail as well."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
    else:
        env = _env(CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True, env=env, cwd=script.parent, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_build_command_targets_the_ignored_build_dir():
    out = _build.library_path()
    assert out.parent == PACKAGE / "build" == _build.BUILD_DIR
    assert out.name.startswith("libsvtpu_kernels_") and out.suffix == ".so"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "snark_verifier_tpu_torch/build/" in ignored
    cmd = _build.nvcc_command(out)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert {"-O3", "-shared", "-fPIC"} <= set(cmd)
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert [Path(c).name for c in cmd if c.endswith(".cu")] == list(_build.KERNEL_SOURCES)
    assert all((_build.CSRC_DIR / s).exists() for s in _build.KERNEL_SOURCES + _build.HEADERS)
    assert len(_build.source_hash()) == 16


def test_wrappers_route_cpu_tensors_to_plain_and_validate():
    a = convert.limbs_to_tensor(F.FQ.encode([3, 5]))
    launches = (FK.mont_mul.launches, CK.g1_add.launches, CK.g1_double.launches, MK.msm_scan.launches)
    assert torch.equal(FK.mont_mul(a, a, F.FQ), FK.mont_mul_plain(a, a, F.FQ))
    g = C.g1_from_affine_ints([None, (1, 2)])
    assert all(torch.equal(x, y) for x, y in zip(CK.g1_add(g, g), CK.g1_add_plain(g, g)))
    assert all(torch.equal(x, y) for x, y in zip(CK.g1_double(g), CK.g1_double_plain(g)))
    assert (FK.mont_mul.launches, CK.g1_add.launches, CK.g1_double.launches, MK.msm_scan.launches) == launches
    with pytest.raises(ValueError):
        FK.mont_mul(a.int(), a, F.FQ)
    with pytest.raises(ValueError):
        FK.mont_mul(a[..., :8], a[..., :8], F.FQ)
    with pytest.raises(ValueError):
        MK.msm_scan(torch.zeros(8, 3, 1, 2, 16, dtype=torch.int64), torch.zeros(2, 1, 64, dtype=torch.int64))
    with pytest.raises(ValueError):
        use_kernel(a, torch.empty(2, 16, dtype=torch.int64, device="meta"))


def test_convert_round_trips_jax_side_numpy():
    limbs = F.FR.encode([1, 2, 3]).reshape(3, 16)
    g = C.g1_from_affine_ints([None, (1, 2)])
    params = convert.to_torch_params(
        {"limbs": limbs, "point": tuple(convert.g1_to_numpy(g)), "named": C.G1(*convert.g1_to_numpy(g)), "k": 8}
    )
    assert params["k"] == 8
    assert params["limbs"].dtype == torch.int64
    np.testing.assert_array_equal(convert.tensor_to_limbs(params["limbs"]), limbs)
    assert isinstance(params["named"], C.G1) and torch.equal(params["named"].y, g.y)
    assert all(torch.equal(x, y) for x, y in zip(params["point"], g))
    assert F.FR.decode(convert.ints_to_tensor([7, 9])).tolist() == [F.FR.from_mont_int(7), F.FR.from_mont_int(9)]
