"""Shared pieces of the emulated-source tests (``tests/test_torch_emulated_
*.py``): the g++ fixture that builds a C++ source against tests/cuda_emu.h,
the rewrite of a CUDA source for that emulation, and a CUDA NaN.

Each block of an emulated launch runs as one host thread per CUDA thread,
so the shapes the tests use are small.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def gxx(tmp_path_factory):
    path = shutil.which("g++")
    if path is None:
        pytest.skip("needs g++ (C++20) to emulate the CUDA sources")
    out = tmp_path_factory.mktemp("emu")

    def compile_(name: str, source: str) -> ctypes.CDLL:
        cpp, so = out / f"{name}.cpp", out / f"{name}.so"
        cpp.write_text(source)
        subprocess.run([path, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-I", str(HERE), "-o", str(so), str(cpp)],
                       check=True, capture_output=True, timeout=300)
        return ctypes.CDLL(str(so))
    return compile_


def _emulated(source: str) -> str:
    """A CUDA source rewritten for tests/cuda_emu.h: the CUDA headers and
    tc_sm80.cuh (whose primitives the emulation defines) dropped, dynamic
    shared memory pointed at the emulator's, static ``__shared__`` arrays of
    any element type made function statics (one block runs at a time), and
    every ``<<<...>>>`` launch made an ``emu_launch``."""
    source = re.sub(r'#include (<cuda_(runtime|bf16)\.h>|"tc_sm80\.cuh")\n',
                    "", source)
    source = '#include "cuda_emu.h"\n' + source
    source = source.replace("extern __shared__ float smem[];",
                            "float* smem = g_smem;")
    source = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?"
                    r"unsigned char (\w+)\[\];",
                    r"unsigned char* \1 = "
                    r"reinterpret_cast<unsigned char*>(g_smem);", source)
    source = re.sub(r"__shared__ (?:__align__\(\d+\) )?([\w:]+) (\w+)\[",
                    r"static \1 \2[", source)
    return re.sub(r"([\w<>, ]+?)<<<(dim3\([^)]*\)|\w+), ([^,]+), [^>]*?>>>"
                  r"\((.*?)\);",
                  r"emu_launch(\2, \3, [&]{ \1(\4); });", source, flags=re.S)


CUDA_NAN = 0x7FFFFFFF


def _cuda_nan():
    return torch.tensor([CUDA_NAN], dtype=torch.int64).to(
        torch.int32).view(torch.float32)[0]
