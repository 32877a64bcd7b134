"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
(with the shared ``csrc/*.cuh`` headers) into a shared library with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` (no PyTorch headers, so a build takes seconds). Libraries land
in ``_kernels_build/`` next to this file, named by a hash of the
source, the headers and the flags, so an edited source is rebuilt and
an unchanged one is reused. ``build()`` starts one ``nvcc``
per missing library, all at once, and waits for all of them. A failed
build raises with the compiler's output: there is no fallback.

Launch counts live here too: every kernel wrapper adds one to its
entry where it launches its kernel, and nowhere else, so a run can
show that it went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         '_kernels_build')
# Library name -> source file under csrc/. flash_bwd.cu holds two
# kernels (flash_dq, flash_dkv); LAUNCHES counts per kernel.
SOURCES = {
    'paged_decode': 'paged_decode.cu',
    'chunk_prefill': 'chunk_prefill.cu',
    'flash_fwd': 'flash_fwd.cu',
    'flash_bwd': 'flash_bwd.cu',
    'verify_attention': 'verify_attention.cu',
}
# -Xptxas -v reports each kernel's registers, shared memory and spills
# (the build log that build() returns).
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-lineinfo',
              '-Xptxas', '-v')

# name -> launches since the last reset_launches().
LAUNCHES: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin '
            'and PATH): the CUDA kernels cannot be built.')
    return found


def _lib_path(name: str) -> str:
    # The shared headers count too: a source includes them.
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in [SOURCES[name]] + headers:
        with open(os.path.join(CSRC_DIR, f), 'rb') as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:16]}.so')


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every missing library among ``names`` (default: all),
    one ``nvcc`` per source, all started together, and wait for them.
    Returns the compiler output of each library built (the ptxas
    report). Raises RuntimeError with the compiler output on failure."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs.append((name, out, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)))
    logs, errors = {}, []
    for name, out, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors='replace')
        if proc.returncode != 0:
            errors.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)        # atomic: readers never see a partial .so
        logs[name] = log
    if errors:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


_functions: Dict[str, ctypes._CFuncPtr] = {}


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name``, its
    argument types set once (ctypes' setter costs host time on every
    call otherwise) and its result an int (a CUDA error code)."""
    fn = _functions.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[symbol] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error '
                           f'{status}')
