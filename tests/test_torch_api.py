"""The port's public surface against the JAX package's, by name.

Every name that a JAX subpackage's `__init__.py` re-exports imports from
the port's subpackage of the same name; every public top-level function
and class of a JAX module has a counterpart of the same name in the port
module at the same path, except the TPU forms in NOT_PORTED (ROADMAP's
"Not ported, by design"), each with its reason. Every port subpackage
imports in a fresh interpreter whichever is imported first, and none of
them imports JAX.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "orb_slam_tpu"

# JAX module (path under orb_slam_tpu/) -> {name: reason}; "*" = the whole
# module
NOT_PORTED = {
    "ops/pallas_fast.py": {"*": "the four Pallas kernels; the port's are "
                                "csrc/*.cu behind ops/fast_score_nms.py, "
                                "fast_score_rect.py, fast_cell_topk.py"},
    "solvers/pose_opt_pallas.py": {"*": "the Pallas pose kernel; the port's "
                                        "is csrc/pose_gn.cu behind "
                                        "solvers/pose_opt.py"},
    "utils/dispatch.py": {"*": "jit dispatch (fused_jit, precise_jit): "
                               "JAX-only; TF32 off stands in for precise_jit"},
    "utils/timing.py": {
        "dispatch_fused": "JAX dispatch of a fused program: JAX-only",
        "force_value": "JAX's sync by reading every leaf back; the port's "
                       "is utils/timing.synchronize_result",
    },
    "ops/matching.py": {"hamming_matrix_mxu": "the MXU matmul form of "
                                              "hamming_matrix, which gives the "
                                              "same distances"},
    "ops/descriptor_stack.py": {
        name: "a TPU gather layout, referenced only inside its own module; "
              "the port gathers with extract_patches and angles_desc_fused"
        for name in ("extract_patches_stack", "ic_angles_stack", "rbrief_stack",
                     "extract_patches_batch2", "ic_angles_from_patches",
                     "rbrief_lut_from_patches")
    } | {
        name: "a TPU patch-gather strategy (one-hot matmul, row gather) of "
              "the same exact values; the port's one gather is extract_patches"
        for name in ("extract_patches_batch", "extract_patches_batch_rowgather")
    },
    "ops/fast_stack.py": {
        "detect_keypoints_stack_pallas": "named detect_keypoints_packed in the "
                                         "port (kernel K1)",
        "fast_score_stack": "in ops/fast.py in the port",
    },
    "ops/orb_descriptor.py": {"pack_u32": "named pack_i32 in the port: the "
                                          "same bits as int32 words, torch "
                                          "has no uint32 arithmetic"},
}

SUBPACKAGES = sorted(p.name for p in (ROOT / "orb_slam_tpu_torch").iterdir()
                     if (p / "__init__.py").exists())


def port_module(rel: str) -> str:
    parts = ("orb_slam_tpu_torch",) + Path(rel).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def public_defs(path: Path) -> list:
    """Public top-level functions and classes of a module, by its source
    (the JAX package is read, not imported)."""
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def reexports(path: Path) -> list:
    """The names an `__init__.py` imports from its package's modules."""
    tree = ast.parse(path.read_text())
    return [a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
            and (n.module or "").startswith("orb_slam_tpu.") for a in n.names]


JAX_INITS = sorted(str(p.parent.relative_to(JAX_PKG)) for p in
                   JAX_PKG.glob("*/__init__.py") if reexports(p))
JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                     if public_defs(p))


def test_the_lists_are_not_empty():
    assert {"geometry", "slam_map", "solvers", "frontend", "utils", "parallel",
            "place"} <= set(JAX_INITS)
    assert len(JAX_MODULES) > 30


@pytest.mark.parametrize("sub", JAX_INITS)
def test_subpackage_reexports(sub):
    names = reexports(JAX_PKG / sub / "__init__.py")
    port = importlib.import_module(f"orb_slam_tpu_torch.{sub}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"orb_slam_tpu_torch.{sub} lacks {missing}"


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_names(rel):
    names = public_defs(JAX_PKG / rel)
    skip = NOT_PORTED.get(rel, {})
    for name in skip:
        assert name == "*" or name in names, f"stale allowlist entry {rel}:{name}"
    if "*" in skip:
        assert not (ROOT / "orb_slam_tpu_torch" / rel).exists()
        return
    port = importlib.import_module(port_module(rel))
    missing = [n for n in names if n not in skip and not hasattr(port, n)]
    assert not missing, f"{port_module(rel)} lacks {missing}"
    for name in skip:
        assert not hasattr(port, name), f"{rel}:{name} is ported: drop it from NOT_PORTED"


def test_geometry_api_runs_on_cpu():
    """The re-exported geometry names work together on CPU tensors."""
    import torch

    from orb_slam_tpu_torch.geometry import (
        CameraModel, project, se3_apply, se3_compose, se3_exp, se3_identity,
        se3_inverse, se3_log, unproject,
    )
    cam = CameraModel.create(500.0, 500.0, 320.0, 240.0)
    T = se3_exp(torch.tensor([[0.1, -0.2, 0.3, 0.01, 0.02, -0.03]]))
    eye = se3_compose(T, se3_inverse(T))
    torch.testing.assert_close(eye[0], se3_identity(device="cpu"), atol=1e-6, rtol=0)
    torch.testing.assert_close(se3_exp(se3_log(T)), T, atol=1e-4, rtol=0)
    p = se3_apply(T, torch.tensor([[0.5, -0.25, 4.0]]))
    uv = project(cam, p)
    torch.testing.assert_close(unproject(cam, uv), p[:, :2] / p[:, 2:], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("first", SUBPACKAGES + ["solvers.local_ba",
                                                 "parallel.sharding",
                                                 "slam_map.serialization"])
def test_imports_in_any_order(first):
    """A fresh interpreter imports `first`, then every subpackage in order
    and in reverse, with JAX blocked."""
    order = [first] + SUBPACKAGES + SUBPACKAGES[::-1]
    code = ("import sys\nsys.modules['jax'] = None\n"
            + "".join(f"import orb_slam_tpu_torch.{m}\n" for m in order)
            + "assert not any(m == 'orb_slam_tpu' or m.startswith('orb_slam_tpu.')"
              " for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
