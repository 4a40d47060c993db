"""Package-level properties of the port (snark_verifier_tpu_torch): it
imports neither JAX nor the JAX package, its copies of JAX-free modules of
the JAX package equal their originals, its kernel wrappers route by device,
validate their inputs and launch through one helper, the modules of its
kernel layer import one way, the kernel build goes to the ignored build
directory, and chip_smoke.py refuses to run without a CUDA card."""

import ast
import contextlib
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
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import msm_cuda as MK
from snark_verifier_tpu_torch.ops import pairing as PAIR
from snark_verifier_tpu_torch.ops import tower as T

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
    assert _build.KERNEL_SOURCES == ("field.cu", "curve.cu", "msm.cu", "tower.cu", "poseidon.cu", "keccak.cu",
                                     "field_add.cu")
    assert all((_build.CSRC_DIR / s).exists() for s in _build.KERNEL_SOURCES + _build.HEADERS)
    assert set(_build.SIGNATURES) >= {
        "svtpu_g1_double", "svtpu_horner_combine", "svtpu_fq12_mul", "svtpu_msm_window", "svtpu_msm_horner",
        "svtpu_miller_loop", "svtpu_final_exp", "svtpu_mont_pow", "svtpu_g1_add_lanes", "svtpu_poseidon_perm",
        "svtpu_keccak256", "svtpu_field_add", "svtpu_field_sub", "svtpu_field_neg", "svtpu_reduce_u256",
        "svtpu_lt_modulus",
    }
    # every C entry of the sources is bound, and nothing else
    entries = {m for s in _build.KERNEL_SOURCES
               for m in re.findall(r'extern "C" int (svtpu_\w+)\(', (_build.CSRC_DIR / s).read_text())}
    assert set(_build.SIGNATURES) == entries
    assert len(_build.source_hash()) == 16


def test_wrappers_route_cpu_tensors_to_plain_and_validate():
    a = convert.limbs_to_tensor(F.FQ.encode([3, 5]), "cpu")
    wrappers = (F.mont_mul, F.mont_pow, C.g1_add, C.g1_double, MK.msm_scan, C.g1_add_select, MK.horner_combine,
                T.fq12_mul_flat, MK.msm_window, MK.msm_horner, PAIR.miller_loop_pair, PAIR.final_exponentiation,
                F.add, F.sub, F.neg, F.reduce_u256, F.lt_modulus)
    launches = [w.launches for w in wrappers]
    assert torch.equal(F.mont_mul(a, a, F.FQ), F.mont_mul_plain(a, a, F.FQ))
    assert torch.equal(F.add(a, a[0], F.FQ), F.add_plain(a, a[0], F.FQ))
    assert torch.equal(F.sub(a[0], a, F.FQ), F.sub_plain(a[0], a, F.FQ))
    assert torch.equal(F.neg(a, F.FQ), F.neg_plain(a, F.FQ))
    assert torch.equal(F.reduce_u256(a, F.FR), F.reduce_u256_plain(a, F.FR))
    assert torch.equal(F.lt_modulus(a, F.FR), F.lt_modulus_plain(a, F.FR))
    assert torch.equal(F.mont_pow(a, 7, F.FQ), F.mont_pow_plain(a, 7, F.FQ))
    g = C.g1_from_affine_ints([None, (1, 2)], "cpu")
    assert all(torch.equal(x, y) for x, y in zip(C.g1_add(g, g), C.g1_add_plain(g, g)))
    assert all(torch.equal(x, y) for x, y in zip(C.g1_double(g), C.g1_double_plain(g)))
    m = torch.tensor([True, False])
    assert all(torch.equal(x, y) for x, y in zip(C.g1_add_select(m, g, g), C.g1_add_select_plain(m, g, g)))
    tot = C.G1(*(c.unsqueeze(0) for c in g))
    assert all(torch.equal(x, y) for x, y in zip(MK.horner_combine(tot, 3), MK.horner_combine_plain(tot, 3)))
    f = torch.cat([a[:1]] * 12).reshape(12, 1, 16)
    assert torch.equal(T.fq12_mul_flat(f, f), T.fq12_mul_flat_plain(f, f))
    assert [w.launches for w in wrappers] == launches
    with pytest.raises(ValueError):
        F.mont_mul(a.int(), a, F.FQ)
    with pytest.raises(ValueError):
        F.mont_mul(a[..., :8], a[..., :8], F.FQ)
    with pytest.raises(ValueError):
        F.mont_pow(a, -1, F.FQ)
    with pytest.raises(ValueError):
        MK.horner_combine(tot, 0)
    with pytest.raises(ValueError):
        MK.msm_scan(torch.zeros(8, 3, 1, 2, 16, dtype=torch.int64), torch.zeros(2, 1, 64, dtype=torch.int64))
    with pytest.raises(ValueError):
        use_kernel(a, torch.empty(2, 16, dtype=torch.int64, device="meta"))
    for op in (F.add, F.sub):  # K12's routes: mixed devices and bad limbs raise, nothing falls back
        with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
            op(a, a.to("meta"), F.FQ)
        with pytest.raises(ValueError):
            op(a, a.int(), F.FQ)
    for op in (F.neg, F.reduce_u256, F.lt_modulus):
        with pytest.raises(ValueError):
            op(a[..., :8], F.FQ)
    assert [w.launches for w in wrappers] == launches


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


# The kernel layer: every module of ops/, and the two it launches through.
LAYER = sorted(f"ops/{p.name}" for p in (PACKAGE / "ops").glob("*.py")) + ["_build.py", "config.py"]


def _module_path(name: str) -> Path | None:
    """The file of a package module name, or None when it is not one."""
    rel = Path(*name.split(".")[1:])
    for path in (PACKAGE / rel.with_suffix(".py"), PACKAGE / rel / "__init__.py"):
        if path.is_file():
            return path
    return None


def _package_imports(path: Path) -> tuple[set[str], list[str]]:
    """The package modules a file imports at its top level, and those it
    imports anywhere below it (inside a function, a class or a block)."""
    tree = ast.parse(path.read_text())
    top, nested = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [f"{node.module}.{a.name}" if _module_path(f"{node.module}.{a.name}") else node.module
                     for a in node.names]
        else:
            continue
        names = [n for n in names if n.split(".")[0] == PACKAGE.name]
        (top.update if node in tree.body else nested.extend)(names)
    return top, nested


@pytest.mark.parametrize("module", LAYER)
def test_kernel_layer_imports_point_one_way(module):
    """No function-level import of the package; the module lies on no cycle
    of the package's top-level imports; ``msm_cuda`` (the MSM kernels)
    never reaches ``msm`` (the MSM algorithms above it); and only
    ``_build.launch`` enters a device and calls the kernel library."""
    name = f"{PACKAGE.name}.{module[:-3].replace('/', '.')}".removesuffix(".__init__")
    path = PACKAGE / module
    top, nested = _package_imports(path)
    assert nested == [], f"{module} imports {nested} inside a function"
    reached, todo = set(), list(top)
    while todo:
        dep = todo.pop()
        if dep not in reached and _module_path(dep):
            reached.add(dep)
            todo.extend(_package_imports(_module_path(dep))[0])
    assert name not in reached, f"{module} imports itself back through {sorted(reached)}"
    if module == "ops/msm_cuda.py":
        assert f"{PACKAGE.name}.ops.msm" not in reached
    if module != "_build.py":
        text = path.read_text()
        assert "library()" not in text and "torch.cuda.device(" not in text


def test_launch_raises_on_a_failed_launch(monkeypatch):
    """``_build.launch`` calls the entry point with the stream of the given
    tensor's device last, inside that device, and raises with the entry's
    name and the CUDA error's text when it returns a non-zero code."""

    class FakeLibrary:
        calls = []

        def svtpu_ok(self, *args):
            self.calls.append(args)
            return 0

        def svtpu_bad(self, *args):
            self.calls.append(args)
            return 700

        def svtpu_error_string(self, code):
            return b"an illegal memory access was encountered"

    lib, devices = FakeLibrary(), []
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: "stream")
    monkeypatch.setattr(torch.cuda, "device", lambda d: devices.append(d) or contextlib.nullcontext())
    like = torch.zeros(2, 16, dtype=torch.int64)
    assert _build.launch("svtpu_ok", like, 1, 2) is None
    with pytest.raises(RuntimeError, match=r"svtpu_bad launch failed: cuda error 700 \(an illegal memory access"):
        _build.launch("svtpu_bad", like, 3)
    assert lib.calls == [(1, 2, "stream"), (3, "stream")] and devices == [like.device] * 2
