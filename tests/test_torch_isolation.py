"""The PyTorch port stands alone: no jax, nothing of the reference
package, CUDA by default and no silent fall back to the plain versions.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import elasticsearch_tpu_torch
from elasticsearch_tpu_torch import resolve_device
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "elasticsearch_tpu_torch"
_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "import importlib\n"
            f"for m in {_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules\n"
            "       if m == 'elasticsearch_tpu'\n"
            "       or m.startswith('elasticsearch_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "elasticsearch_tpu_torch.search.executor" in _MODULES


def test_no_source_names_jax_or_the_reference():
    imp = re.compile(r"^\s*(?:from|import)\s+(jax\b|jaxlib\b|"
                     r"elasticsearch_tpu(?!_torch)\b|bench\b)", re.M)
    for path in _sources():
        text = path.read_text()
        assert not imp.search(text), path


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardReader("logs", [], {}, MapperService())
    assert resolve_device("cpu") == torch.device("cpu")


def test_device_tensors_never_reach_the_plain_versions(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: here
    (meta tensors, no nvcc) it raises, and the plain versions, which
    would have answered, are never called and nothing is counted."""
    def boom(*a, **k):
        raise AssertionError("plain version reached for a device tensor")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cs, "dense_score_ref", boom)
    monkeypatch.setattr(cs, "scatter_add_ref", boom)
    monkeypatch.setattr(cs, "_nvcc", no_nvcc)
    monkeypatch.setattr(cs, "_LIBS", {})
    before = dict(cs.LAUNCHES)
    meta = torch.device("meta")
    tids = torch.empty((256, 8), dtype=torch.int32, device=meta)
    imps = torch.empty((256, 8), dtype=torch.float32, device=meta)
    qt = torch.empty((4, 2), dtype=torch.int32, device=meta)
    wq = torch.empty((4, 2), dtype=torch.float32, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        cs.dense_score(tids, imps, qt, wq)
    docs = torch.empty((4, 256), dtype=torch.int32, device=meta)
    vals = torch.empty((4, 256), dtype=torch.float32, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        cs.scatter_add(docs, vals, 256)
    # wrong dtype / layout raise before any build
    with pytest.raises(TypeError):
        cs.dense_score(tids, imps, qt.to(torch.int64), wq)
    with pytest.raises(ValueError):
        cs.scatter_add(docs[:, ::2], vals[:, ::2], 256)
    assert cs.LAUNCHES == before


def test_bundle_wrappers_never_take_the_plain_walk_for_device_tensors(
        monkeypatch):
    """K3's entries on tensors that are not on the CPU launch the kernel
    or raise (here: meta tensors, no nvcc); the plain walk is never
    called and nothing is counted."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds

    def boom(*a, **k):
        raise AssertionError("plain walk reached for a device tensor")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    for name in ("bundle_walk_ref", "fused_topk_bundle_ref",
                 "match_mask_bundle_ref"):
        monkeypatch.setattr(cs, name, boom)
    monkeypatch.setattr(cs, "_nvcc", no_nvcc)
    monkeypatch.setattr(cs, "_LIBS", {})
    before = dict(cs.LAUNCHES)
    meta = torch.device("meta")
    B, cap, n_tiles = 4, 2048, 2
    text = {"f": {"fwd_tids": torch.empty((cap, 8), dtype=torch.int32,
                                          device=meta),
                  "fwd_imps": torch.empty((cap, 8), device=meta),
                  "tile_max": torch.empty((50, n_tiles), device=meta)}}
    clauses = (("should", "terms_dense", "f", False),)
    cl = ((torch.empty((B, 2), dtype=torch.int32, device=meta),
           torch.empty((B, 2), device=meta),
           torch.empty((B,), dtype=torch.int32, device=meta),
           torch.empty((B,), device=meta)),)
    msm = torch.empty((B,), dtype=torch.int32, device=meta)
    live = torch.empty((cap,), dtype=torch.bool, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        cs.fused_topk_bundle(text, {}, clauses, cl, msm, None, live, 10)
    with pytest.raises(RuntimeError, match="nvcc"):
        cs.match_mask_bundle(text, {}, clauses, cl, msm, None, live)
    # a column of the wrong dtype raises before any build
    bad = dict(text["f"], fwd_imps=text["f"]["fwd_imps"].to(torch.float64))
    can, ub = bundle_tile_bounds(clauses, cl, text, {}, msm, None)
    with pytest.raises(TypeError):
        cs.bundle_walk({"f": bad}, {}, clauses, cl, msm, msm, live, can, ub,
                       ck=10, update_thr=True, emit_match=False)
    assert cs.LAUNCHES == before


def test_stepped_and_seeded_walks_never_take_the_plain_walk(monkeypatch):
    """The stepped and the chained (seeded) K3 entries on tensors that
    are not on the CPU launch the kernel or raise (meta tensors, no
    nvcc): the check runs before the first chunk, the plain walk is
    never called, nothing is counted; a tile span past the grid raises
    before any build."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds

    def boom(*a, **k):
        raise AssertionError("plain walk reached for a device tensor")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    for name in ("bundle_walk_ref", "fused_topk_bundle_ref",
                 "match_mask_bundle_ref"):
        monkeypatch.setattr(cs, name, boom)
    monkeypatch.setattr(cs, "_nvcc", no_nvcc)
    monkeypatch.setattr(cs, "_LIBS", {})
    before = dict(cs.LAUNCHES)
    meta = torch.device("meta")
    B, cap, n_tiles = 4, 2048, 2
    text = {"f": {"fwd_tids": torch.empty((cap, 8), dtype=torch.int32,
                                          device=meta),
                  "fwd_imps": torch.empty((cap, 8), device=meta),
                  "tile_max": torch.empty((50, n_tiles), device=meta)}}
    clauses = (("should", "terms_dense", "f", False),)
    cl = ((torch.empty((B, 2), dtype=torch.int32, device=meta),
           torch.empty((B, 2), device=meta),
           torch.empty((B,), dtype=torch.int32, device=meta),
           torch.empty((B,), device=meta)),)
    msm = torch.empty((B,), dtype=torch.int32, device=meta)
    live = torch.empty((cap,), dtype=torch.bool, device=meta)
    checked = []

    def check(c, st):
        checked.append(c)
        return False, st

    with pytest.raises(RuntimeError, match="nvcc"):
        cs.fused_topk_bundle(text, {}, clauses, cl, msm, None, live, 10,
                             step=(1, None, check))
    assert checked == [0]
    with pytest.raises(RuntimeError, match="nvcc"):
        cs.match_mask_bundle(text, {}, clauses, cl, msm, None, live,
                             step=(1, None, check))
    init = (torch.empty((B, 10), device=meta),
            torch.empty((B, 10), dtype=torch.int32, device=meta))
    with pytest.raises(RuntimeError, match="nvcc"):
        cs.fused_topk_bundle(text, {}, clauses, cl, msm, None, live, 10,
                             init_topk=init, idx_offset=cap)
    can, ub = bundle_tile_bounds(clauses, cl, text, {}, msm, None)
    with pytest.raises(ValueError, match="tiles"):
        cs.bundle_walk(text, {}, clauses, cl, msm, msm, live, can, ub,
                       ck=10, update_thr=True, emit_match=False, t0=1, nt=2)
    assert cs.LAUNCHES == before


@pytest.mark.parametrize("module", ["elasticsearch_tpu_torch.search.resident",
                                    "elasticsearch_tpu_torch.utils.metrics",
                                    "elasticsearch_tpu_torch.search.executor"])
def test_streaming_and_resident_modules_stand_alone(module):
    """The modules of the streaming read path and the resident loop
    import with jax blocked and load nothing of the reference package."""
    assert module in _MODULES
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            f"import {module} as m\n"
            "bad = [n for n in sys.modules\n"
            "       if n == 'elasticsearch_tpu'\n"
            "       or n.startswith('elasticsearch_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    src = (ROOT / (module.replace(".", "/") + ".py")).read_text()
    assert "jax" not in src.replace("elasticsearch_tpu_torch", "")


def test_positional_leaf_never_takes_the_plain_version_for_device_tensors(
        monkeypatch):
    """The unfused positional leaf on tensors that are not on the CPU
    launches its kernel or raises; a shape past the kernel's caps raises
    before any build."""
    def boom(*a, **k):
        raise AssertionError("plain leaf reached for a device tensor")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cs, "positional_leaf_ref", boom)
    monkeypatch.setattr(cs, "_nvcc", no_nvcc)
    monkeypatch.setattr(cs, "_LIBS", {})
    before = dict(cs.LAUNCHES)
    meta = torch.device("meta")
    B, cap, L, P = 3, 512, 8, 2
    cols = {"f": {"fwd_tids": torch.empty((cap, L), dtype=torch.int32,
                                          device=meta),
                  "fwd_imps": torch.empty((cap, L), device=meta),
                  "fwd_pos": torch.empty((cap, L * P), dtype=torch.int16,
                                         device=meta),
                  "k1ln": torch.empty((cap,), device=meta),
                  "lnorm": torch.empty((cap,), device=meta)}}

    def inp(n):
        return (torch.empty((B, n), dtype=torch.int32, device=meta),
                torch.empty((B, n), device=meta),
                torch.empty((B,), device=meta),
                torch.empty((B,), dtype=torch.int32, device=meta),
                torch.empty((B,), device=meta),
                torch.ones((B,), dtype=torch.int32, device=meta),
                torch.ones((B,), device=meta))

    with pytest.raises(RuntimeError, match="nvcc"):
        cs.positional_leaf("phrase_pos:2:s", "f", inp(2), cols)
    with pytest.raises(ValueError, match="terms"):
        cs.positional_leaf("phrase_pos:9:e", "f", inp(9), cols)
    bad = dict(cols["f"], fwd_pos=cols["f"]["fwd_pos"].to(torch.int32))
    with pytest.raises(TypeError):
        cs.positional_leaf("span_pos:2:o", "f", inp(2), {"f": bad})
    assert cs.LAUNCHES == before


def test_kernel_build_covers_the_shared_header(tmp_path, monkeypatch):
    """K3 and its unfused entry share csrc/positional_leaf.cuh: the
    source includes it, and a change to it changes the build output the
    wrapper loads (so a stale library is never reused)."""
    import shutil
    src = (cs._CSRC / "bundle_topk.cu").read_text()
    assert '#include "positional_leaf.cuh"' in src
    assert (cs._CSRC / "positional_leaf.cuh").exists()
    assert cs._ENTRIES["positional_leaf"] == "bundle_topk"
    copy_dir = tmp_path / "csrc"
    shutil.copytree(cs._CSRC, copy_dir)
    monkeypatch.setattr(cs, "_CSRC", copy_dir)
    before = cs._lib_path("bundle_topk")
    with open(copy_dir / "positional_leaf.cuh", "a") as f:
        f.write("\n// edited\n")
    assert cs._lib_path("bundle_topk") != before
    assert "--use_fast_math" not in cs._NVCC_FLAGS


def test_positional_caps_have_one_definition():
    """The executor admits positional clauses up to the caps of
    ops/cuda_scoring, and the kernel's header mirrors the same numbers."""
    from elasticsearch_tpu_torch.search import executor
    assert executor._POS_CLAUSE_TERMS_MAX is cs.POS_MAX_TERMS
    assert executor._POS_FIELDS_MAX is cs.POS_MAX_FIELDS
    head = (cs._CSRC / "positional_leaf.cuh").read_text()
    found = dict(re.findall(r"constexpr int (kMax\w+) = (\d+);", head))
    assert int(found["kMaxTerms"]) == cs.POS_MAX_TERMS
    assert int(found["kMaxFields"]) == cs.POS_MAX_FIELDS
    src = (PORT / "search" / "executor.py").read_text()
    assert not re.search(r"^_POS_\w+_MAX\s*=", src, re.M)


@pytest.mark.parametrize("alone", [True, False])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    """Without a card the smoke exits non-zero and prints no result line;
    copied into a directory of its own it cannot find the package."""
    script = ROOT / "chip_smoke.py"
    cwd = tmp_path if alone else ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert elasticsearch_tpu_torch.__name__ == "elasticsearch_tpu_torch"


def test_chip_smoke_rehearsal_on_cpu():
    """The smoke's main-path checks (mixes, merge, plain-version swap)
    run end to end on the CPU at a toy size."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse"],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("rehearse: ")
    assert '"ok": true' not in proc.stdout
