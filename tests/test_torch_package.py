"""Package-level properties of the port (snark_verifier_tpu_torch): it
imports neither JAX nor the JAX package, its copies of JAX-free modules of
the JAX package equal their originals, its kernel wrappers route by device
and validate their inputs, the kernel build goes to the ignored build
directory, and chip_smoke.py refuses to run without a CUDA card."""

import ast
import os
import re
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
from snark_verifier_tpu_torch.ops import pairing as PAIR
from snark_verifier_tpu_torch.ops import tower_cuda as TC

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "snark_verifier_tpu_torch"
ORIGINAL = REPO / "snark_verifier_tpu"

# The port's copies of JAX-free modules of the JAX package, at the same
# relative paths -> the top-level definitions of the original that the copy
# leaves out (the port does not use them).  The port has no
# ``util/native_ec.py``, so its ``bn254.fast_msm`` (the IPA prover's and
# native decide's MSM) always takes the pure-python oracle.
COPIES = {
    "errors.py": (),
    "util/__init__.py": (),
    "util/bn254.py": (),
    "util/fraction.py": (),
    "util/msm_symbolic.py": (),
    "util/transcript.py": (),
    "util/keccak.py": (),
    "util/poseidon.py": (),
    "util/poseidon_opt.py": (),
    "util/curves.py": (),
    "util/metrics.py": (),
    "ops/limbs.py": (),
    "loader/__init__.py": (),
    "loader/native.py": (),
    "verifier/__init__.py": (),
    "verifier/plonk/__init__.py": (),
    "verifier/plonk/proof.py": (),
    "verifier/plonk/protocol.py": (),
    "verifier/plonk/serialization.py": (),
    "pcs/__init__.py": (),
    "pcs/kzg/__init__.py": (),
    "pcs/kzg/accumulation.py": (),
    "pcs/kzg/accumulator.py": (),
    "pcs/kzg/bdfg21.py": (),
    "pcs/kzg/decider.py": (),
    "pcs/kzg/gwc19.py": (),
    "pcs/ipa/__init__.py": (),
    "pcs/ipa/bgh19.py": (),
    "system/__init__.py": (),
    "system/halo2/__init__.py": (),
    "system/halo2/transcript.py": ("NativeBlake2bTranscript",),
    "sdk/aggregation.py": ("aggregate_in_circuit",),
}

BLOCK_JAX = """
import importlib, pkgutil, sys

BLOCKED = ("jax", "snark_verifier_tpu")

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import snark_verifier_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from snark_verifier_tpu_torch import entry
entry.fixture()
entry.poseidon_fixture()
entry.aggregation_fixture()
assert not [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
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
    assert int(proc.stdout.strip().splitlines()[-1]) >= 40  # every module of the package


def _module_nodes(path: Path, drop=()) -> list[str]:
    """The module's top-level statements as AST dumps (comments are not in
    the AST), with the port's package name read as the JAX package's, a
    reference-source path in a docstring reduced to its path inside the
    reference repo, and the named definitions left out."""
    text = re.sub(r"\bsnark_verifier_tpu_torch\b", "snark_verifier_tpu", path.read_text())
    text = re.sub(r"(?:/\S+/)?snark-verifier[/ ]src/", "snark-verifier src/", text)
    return [ast.dump(n) for n in ast.parse(text).body if getattr(n, "name", None) not in drop]


@pytest.mark.parametrize("module", list(COPIES))
def test_copied_module_equals_its_original(module):
    """Each copy is its original apart from the package name (imports) and
    the definitions the port leaves out, so a change to either side fails."""
    original = _module_nodes(ORIGINAL / module, COPIES[module])
    assert _module_nodes(PACKAGE / module) == original
    assert len(_module_nodes(ORIGINAL / module)) == len(original) + len(COPIES[module])


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
    objs = [_build.BUILD_DIR / f"{Path(s).stem}.o" for s in _build.KERNEL_SOURCES]
    for source, obj in zip(_build.KERNEL_SOURCES, objs):  # one nvcc per source
        cmd = _build.compile_command(source, obj)
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        assert {"-O3", "-c", "-fPIC"} <= set(cmd)
        assert cmd[cmd.index("-o") + 1] == str(obj)
        assert [Path(c).name for c in cmd if c.endswith(".cu")] == [source]
    link = _build.link_command(out, objs)
    assert "-shared" in link and link[link.index("-o") + 1] == str(out) and link[-len(objs):] == list(map(str, objs))
    assert _build.KERNEL_SOURCES == ("field.cu", "curve.cu", "msm.cu", "tower.cu")
    assert all((_build.CSRC_DIR / s).exists() for s in _build.KERNEL_SOURCES + _build.HEADERS)
    assert set(_build.SIGNATURES) >= {
        "svtpu_g1_double", "svtpu_horner_combine", "svtpu_fq12_mul", "svtpu_msm_window", "svtpu_msm_horner",
        "svtpu_miller_loop", "svtpu_final_exp", "svtpu_mont_pow", "svtpu_g1_add_lanes",
    }
    # every C entry of the sources is bound, and nothing else
    entries = {m for s in _build.KERNEL_SOURCES
               for m in re.findall(r'extern "C" int (svtpu_\w+)\(', (_build.CSRC_DIR / s).read_text())}
    assert set(_build.SIGNATURES) == entries
    assert len(_build.source_hash()) == 16


def test_wrappers_route_cpu_tensors_to_plain_and_validate():
    a = convert.limbs_to_tensor(F.FQ.encode([3, 5]), "cpu")
    wrappers = (FK.mont_mul, FK.mont_pow, CK.g1_add, CK.g1_double, MK.msm_scan, CK.g1_add_select, MK.horner_combine,
                TC.fq12_mul_flat, MK.msm_window, MK.msm_horner, PAIR.miller_loop_pair, PAIR.final_exponentiation)
    launches = [w.launches for w in wrappers]
    assert torch.equal(FK.mont_mul(a, a, F.FQ), FK.mont_mul_plain(a, a, F.FQ))
    assert torch.equal(FK.mont_pow(a, 7, F.FQ), FK.mont_pow_plain(a, 7, F.FQ))
    g = C.g1_from_affine_ints([None, (1, 2)], "cpu")
    assert all(torch.equal(x, y) for x, y in zip(CK.g1_add(g, g), CK.g1_add_plain(g, g)))
    assert all(torch.equal(x, y) for x, y in zip(CK.g1_double(g), CK.g1_double_plain(g)))
    m = torch.tensor([True, False])
    assert all(torch.equal(x, y) for x, y in zip(CK.g1_add_select(m, g, g), CK.g1_add_select_plain(m, g, g)))
    tot = C.G1(*(c.unsqueeze(0) for c in g))
    assert all(torch.equal(x, y) for x, y in zip(MK.horner_combine(tot, 3), MK.horner_combine_plain(tot, 3)))
    f = torch.cat([a[:1]] * 12).reshape(12, 1, 16)
    assert torch.equal(TC.fq12_mul_flat(f, f), TC.fq12_mul_flat_plain(f, f))
    assert [w.launches for w in wrappers] == launches
    with pytest.raises(ValueError):
        FK.mont_mul(a.int(), a, F.FQ)
    with pytest.raises(ValueError):
        FK.mont_mul(a[..., :8], a[..., :8], F.FQ)
    with pytest.raises(ValueError):
        FK.mont_pow(a, -1, F.FQ)
    with pytest.raises(ValueError):
        MK.horner_combine(tot, 0)
    with pytest.raises(ValueError):
        MK.msm_scan(torch.zeros(8, 3, 1, 2, 16, dtype=torch.int64), torch.zeros(2, 1, 64, dtype=torch.int64))
    with pytest.raises(ValueError):
        use_kernel(a, torch.empty(2, 16, dtype=torch.int64, device="meta"))


def test_convert_round_trips_jax_side_numpy():
    limbs = F.FR.encode([1, 2, 3]).reshape(3, 16)
    g = C.g1_from_affine_ints([None, (1, 2)], "cpu")
    params = convert.to_torch_params(
        {"limbs": limbs, "point": tuple(convert.g1_to_numpy(g)), "named": C.G1(*convert.g1_to_numpy(g)), "k": 8}, "cpu"
    )
    assert params["k"] == 8
    assert params["limbs"].dtype == torch.int64
    np.testing.assert_array_equal(convert.tensor_to_limbs(params["limbs"]), limbs)
    assert isinstance(params["named"], C.G1) and torch.equal(params["named"].y, g.y)
    assert all(torch.equal(x, y) for x, y in zip(params["point"], g))
    assert F.FR.decode(convert.ints_to_tensor([7, 9], "cpu")).tolist() == [F.FR.from_mont_int(7), F.FR.from_mont_int(9)]


def test_mega_is_read_at_every_call(monkeypatch):
    """``msm_cuda.MEGA`` picks the one-kernel scan (K4) or the two-kernel
    form (K8/K9) at each call of ``msm_batched_fused``, not at import; it
    starts from SVTPU_TORCH_MSM_MEGA ("1" unless set)."""
    from snark_verifier_tpu_torch.util import bn254

    calls = []
    monkeypatch.setattr(MK, "msm_scan", lambda *a: calls.append("scan") or MK.msm_scan_plain(*a))
    monkeypatch.setattr(MK, "msm_window", lambda *a: calls.append("window") or MK.msm_window_plain(*a))
    g = C.g1_from_affine_ints([(1, 2), None], "cpu")
    pts = C.G1(*(c.reshape(1, 2, 16) for c in g))
    scalars = convert.ints_to_tensor([3, 5], "cpu").reshape(1, 2, 16)
    for mega in (True, False, True):
        calls.clear()
        monkeypatch.setattr(MK, "MEGA", mega)
        assert C.g1_to_affine_ints(MK.msm_batched_fused(pts, scalars, 1)) == [bn254.g1_mul((1, 2), 3)]
        assert calls == (["scan"] if mega else ["window"])
    env = _env()
    env.pop("SVTPU_TORCH_MSM_MEGA", None)
    for value, want in ((None, True), ("0", False)):
        if value is not None:
            env["SVTPU_TORCH_MSM_MEGA"] = value
        proc = subprocess.run(
            [sys.executable, "-c", "from snark_verifier_tpu_torch.ops import msm_cuda; print(msm_cuda.MEGA)"],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
        )
        assert proc.stdout.strip() == str(want), proc.stderr


def test_device_check_accepts_the_default_cuda_device():
    """``build_verifier``/``build_batch_decider`` default to "cuda", while
    tensors created there report "cuda:0": the input check takes a device
    without an index as any index of its type."""
    from types import SimpleNamespace

    from snark_verifier_tpu_torch.parallel.batch import on_device

    cuda0, cuda1 = SimpleNamespace(device=torch.device("cuda", 0)), SimpleNamespace(device=torch.device("cuda", 1))
    assert on_device(cuda0, torch.device("cuda")) and on_device(cuda1, torch.device("cuda"))
    assert on_device(cuda0, torch.device("cuda", 0)) and not on_device(cuda1, torch.device("cuda", 0))
    assert not on_device(torch.zeros(1), torch.device("cuda")) and on_device(torch.zeros(1), torch.device("cpu"))
