"""The host C++ DBoW2 text-vocabulary parser, built and loaded with ctypes.

Port of orb_slam_tpu/native/__init__.py:15-108 (`load_vocab_parser`,
`parse_vocab_text`). `vocab_parser.cpp` here is a byte-equal copy of
orb_slam_tpu/native/vocab_parser.cpp (a test holds the two equal): an mmap
scanner of the reference's text format (ORBvoc.txt,
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:241-247), where the
reference's istream loader takes minutes on ~1M nodes.

The library is compiled with the host C++ compiler (`g++ -O3 -shared
-fPIC`, the compiler nvcc itself drives) at first use, never at import,
into the port's gitignored `_build/`, named by a hash of the source and
the flags. Unlike the JAX package there is no fallback: a missing
compiler, a failed build or a file the parser rejects raises. The
pure-Python parser of `place/vocabulary.py::load_text_plain` is the plain
version the tests hold this one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "vocab_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    """_build/vocab_parser-<hash>.so, the hash over the source and flags."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"vocab_parser-{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile vocab_parser.cpp unless its library is already built.
    Returns the library path; raises RuntimeError if the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH: the "
                           "vocabulary text parser cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_vocab_parser():
    """The ctypes library of the parser, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.vocab_count_nodes.restype = ctypes.c_int
        lib.vocab_count_nodes.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.vocab_parse.restype = ctypes.c_int
        lib.vocab_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def parse_vocab_text(path: str):
    """(k, L, parent [n] i32, is_leaf [n] u8, desc [n + 1, 32] u8, weight
    [n] f32) of a DBoW2 text vocabulary, with 1-based node ids (row 0 of
    desc is the root). Raises ValueError if the parser rejects the file."""
    lib = load_vocab_parser()
    k = ctypes.c_int()
    L = ctypes.c_int()
    n = lib.vocab_count_nodes(str(path).encode(), ctypes.byref(k),
                              ctypes.byref(L))
    if n < 0:
        raise ValueError(f"{path}: not a readable DBoW2 text vocabulary")
    parent = np.zeros(n, np.int32)
    is_leaf = np.zeros(n, np.uint8)
    desc = np.zeros((n + 1, 32), np.uint8)
    weight = np.zeros(n, np.float32)
    rc = lib.vocab_parse(
        str(path).encode(), n, k.value,
        parent.ctypes.data_as(ctypes.c_void_p),
        is_leaf.ctypes.data_as(ctypes.c_void_p),
        desc.ctypes.data_as(ctypes.c_void_p),
        weight.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{path}: the DBoW2 text parser stopped with code {rc}")
    return k.value, L.value, parent, is_leaf, desc, weight
