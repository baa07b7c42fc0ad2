"""Generate, build and load the CUDA tile kernel for a lowered spec.

The tile kernel is hand-written in ``csrc/stencil_tile.cuh``; only the
expressions depend on the spec.  :func:`generate` turns every stage of a
lowered :class:`~repro_torch.core.spec.StencilSpec` (``Let``/``Var``/
``BinOp``/``Call``/``Neg``/``Num``/``Ref``) into a ``sasa_stage<k>``
device function in ``spec_body.cuh`` and writes a translation unit that
sets the spec's constants and includes the template.  Nothing else goes
into a build.

Build (route (b): a plain C entry point loaded with ``ctypes``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -fmad=false -prec-div=true -prec-sqrt=true \\
         -ftz=false -I csrc -I <build dir> kernel.cu -o libsasa.so

``-fmad=false`` and IEEE division keep one rounding per operation.  A
``Num`` is emitted as the exact float32 value of ``np.float32(value)``
as a hex-float literal (a decimal literal could round twice).  bfloat16
specs compute in float and round to bfloat16 where a stage writes.

The shared library is cached by a hash of the generated sources, the
template sources in ``csrc/`` and the flags, under
``build/repro_torch_kernels/<key>/`` at the root of the checkout.  Grid
shape, tile, halo and fusion depth are launch arguments, so one build
serves every shape and depth of a spec's structure.  :func:`build_many`
starts one ``nvcc`` per missing library, all at once, and counts each
compile on ``build_many.compiles``.

The built library is also what the persistent design store carries
(:mod:`repro_torch.runtime.store`, tier ``cuda_so``): :func:`export_library`
reads it, and :func:`install_library` writes a stored blob into the build
directory and loads it, so :func:`get_kernel` finds it without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from repro_torch.core.spec import (
    BinOp,
    Call,
    Expr,
    Let,
    Neg,
    Num,
    Ref,
    StencilSpec,
    Var,
)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-ftz=false",
)
BOUNDARY_CODES = {"zero": 0, "constant": 1, "replicate": 2, "periodic": 3}
SUPPORTED_DTYPES = ("float32", "bfloat16")


def index_inputs(spec: StencilSpec) -> tuple[str, ...]:
    """The streamed int32 index maps of a bucket spec (halo, then wrap)."""
    return tuple(spec.halo_index_inputs) + tuple(spec.wrap_index_inputs)


def float_inputs(spec: StencilSpec) -> list[str]:
    """The inputs the kernel stages in shared memory, in spec order."""
    skip = set(index_inputs(spec))
    return [n for n in spec.inputs if n not in skip]


def check_supported(spec: StencilSpec) -> None:
    """Raise for what the CUDA tile kernel does not take."""
    if not 1 <= spec.ndim <= 3:
        raise NotImplementedError(f"{spec.ndim}-D specs are not supported")
    for n in index_inputs(spec):
        if spec.inputs[n][0] != "int32":
            raise NotImplementedError(
                f"index input {n!r} of {spec.name!r} is "
                f"{spec.inputs[n][0]}, not int32"
            )
    if spec.halo_index_inputs and spec.boundary.kind != "replicate":
        # the producer (runtime.bucketing.masked_spec) threads halo maps
        # into replicate specs only; under another rule the plain version
        # would read maps the boundary rule has rewritten
        raise NotImplementedError(
            f"halo-index maps under a {spec.boundary.kind} boundary"
        )
    dtypes = {spec.inputs[n][0] for n in float_inputs(spec)}
    dtypes |= {st.dtype for st in spec.stages}
    if len(dtypes) != 1 or spec.dtype not in SUPPORTED_DTYPES:
        raise NotImplementedError(
            f"the CUDA tile kernel needs one dtype among {SUPPORTED_DTYPES} "
            f"for every floating array, got {sorted(dtypes)}"
        )


# --------------------------------------------------------------------------
# Code generation
# --------------------------------------------------------------------------


def float_literal(value: float) -> str:
    """The exact float32 value of ``value`` as a C++ hex-float literal."""
    f = float(np.float32(value))
    if not np.isfinite(f):
        raise ValueError(f"constant {value!r} is not finite in float32")
    return f"({f.hex()}f)"


class _Emitter:
    def __init__(self, spec: StencilSpec, buffers: dict[str, int]):
        self.ndim = spec.ndim
        self.buffers = buffers
        self.lines: list[str] = []
        self.n_vars = 0

    def expr(self, e: Expr, env: dict[str, str]) -> str:
        if isinstance(e, Num):
            return float_literal(e.value)
        if isinstance(e, Ref):
            offs = (0,) * (3 - self.ndim) + tuple(int(o) for o in e.offsets)
            return (
                f"sasa_tap<{offs[0]}, {offs[1]}, {offs[2]}>"
                f"(env[{self.buffers[e.name]}], c, g)"
            )
        if isinstance(e, Var):
            return env[e.name]
        if isinstance(e, Let):
            env = dict(env)
            for name, bound in e.bindings:
                value = self.expr(bound, env)
                var = f"v{self.n_vars}"
                self.n_vars += 1
                self.lines.append(f"  const float {var} = {value};")
                env[name] = var
            return self.expr(e.body, env)
        if isinstance(e, Neg):
            return f"(-{self.expr(e.arg, env)})"
        if isinstance(e, BinOp):
            if e.op not in "+-*/":
                raise ValueError(f"unknown op {e.op!r}")
            return f"({self.expr(e.lhs, env)} {e.op} {self.expr(e.rhs, env)})"
        if isinstance(e, Call):
            args = [self.expr(a, env) for a in e.args]
            if e.fn == "abs":
                return f"fabsf({args[0]})"
            acc = args[0]
            for a in args[1:]:
                acc = f"sasa_{e.fn}({acc}, {a})"
            return acc
        raise TypeError(f"cannot emit expression node {e!r}")


def generate(spec: StencilSpec) -> tuple[str, str]:
    """``(kernel.cu, spec_body.cuh)`` sources for a lowered spec."""
    # the tile geometry lives with the kernel's wrapper, which imports this
    from repro_torch.kernels.stencil import frame_width, stage_tails

    check_supported(spec)
    names = float_inputs(spec)
    locals_ = spec.local_stages
    buffers = {n: i for i, n in enumerate(names)}
    for k, st in enumerate(locals_):
        buffers[st.name] = len(names) + k
    body = [
        f"// Stages of {spec.name}, generated by kernels/cuda_build.py.",
    ]
    calls = []
    tails = stage_tails(spec)
    for k, st in enumerate(spec.stages):
        em = _Emitter(spec, buffers)
        result = em.expr(st.expr, {})
        body += [
            "template <>",
            f"__device__ __forceinline__ float sasa_stage<{k}>(",
            "    const float* const* env, int c, const SasaGeom& g) {",
            *em.lines,
            f"  return {result};",
            "}",
        ]
        dst = "nxt" if st.is_output else f"buf[SASA_N_IN + {k}]"
        calls.append(f"SASA_STAGE({k}, {tails[k]}, {dst})")
    body.append("#define SASA_STAGE_CALLS " + " ".join(calls))
    b = spec.boundary
    tu = "\n".join([
        f"// {spec.name}: generated by kernels/cuda_build.py.",
        f"#define SASA_N_IN {len(names)}",
        f"#define SASA_ITER {names.index(spec.iterate_input)}",
        f"#define SASA_N_HALO {len(spec.halo_index_inputs)}",
        f"#define SASA_N_LOCAL {len(locals_)}",
        f"#define SASA_NDIM {spec.ndim}",
        f"#define SASA_RADIUS {spec.radius}",
        f"#define SASA_FRAME {frame_width(spec)}",
        f"#define SASA_BOUNDARY {BOUNDARY_CODES[b.kind]}",
        f"#define SASA_BVALUE {float_literal(b.value)}",
        f"#define SASA_STORE_BF16 {int(spec.dtype == 'bfloat16')}",
        '#include "stencil_tile.cuh"',
        "",
    ])
    return tu, "\n".join(body) + "\n"


@functools.lru_cache(maxsize=1)
def _csrc_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def kernel_key(spec: StencilSpec) -> str:
    """Structural fingerprint of the build: generated sources, template,
    flags.  Specs that differ only in shape or iterations share it."""
    tu, body = generate(spec)
    h = hashlib.sha256()
    for part in (tu, body, _csrc_hash(), " ".join(NVCC_FLAGS)):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()[:24]


# --------------------------------------------------------------------------
# Build and load
# --------------------------------------------------------------------------


class KernelLib:
    """One built tile kernel: ``launch(ins, maps, out, geom, stream)``."""

    def __init__(self, path: Path, key: str, build_log: str = ""):
        self.path = path
        self.key = key
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        fn = self._lib.sasa_launch
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        self._fn = fn

    def launch(self, in_ptrs, map_ptrs, out_ptr: int, geom, stream: int) -> int:
        ins = (ctypes.c_uint64 * len(in_ptrs))(*in_ptrs)
        maps = (ctypes.c_uint64 * max(len(map_ptrs), 1))(*map_ptrs)
        g = (ctypes.c_int * len(geom))(*geom)
        return int(self._fn(ins, maps, ctypes.c_void_p(out_ptr), g,
                            ctypes.c_void_p(stream)))


# Loaded libraries of this process, by key and by spec.  A loaded shared
# library is process-wide state in any case; these only avoid loading it
# twice and regenerating sources on every launch.
_LOADED: dict[str, KernelLib] = {}
_BY_SPEC: dict[StencilSpec, KernelLib] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA tile kernel cannot be built")


def build_many(specs, ptxas_info: bool = False) -> list[KernelLib]:
    """Build (where missing) and load the kernel of every spec.

    One ``nvcc`` process is started per missing library, all together,
    then each is awaited.  A failed build raises with the compiler's
    output.  ``ptxas_info`` adds ``-Xptxas -v`` and keeps the compiler's
    report on ``KernelLib.build_log``.
    """
    root = BUILD_ROOT
    with _LOCK:
        keys = [kernel_key(s) for s in specs]
        jobs = {}
        for spec, key in zip(specs, keys):
            if key in _LOADED or key in jobs:
                continue
            d = root / key
            so = d / "libsasa.so"
            if so.exists() and not ptxas_info:
                continue
            d.mkdir(parents=True, exist_ok=True)
            tu, body = generate(spec)
            (d / "kernel.cu").write_text(tu)
            (d / "spec_body.cuh").write_text(body)
            tmp = d / f"libsasa.{os.getpid()}.so"
            cmd = [nvcc_path(), *NVCC_FLAGS]
            if ptxas_info:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-I", str(CSRC), "-I", str(d), str(d / "kernel.cu"),
                    "-o", str(tmp)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            jobs[key] = (proc, tmp, so)
        logs = {}
        failed = []
        for key, (proc, tmp, so) in jobs.items():
            out, _ = proc.communicate()
            logs[key] = out
            build_many.compiles += 1
            if proc.returncode != 0:
                failed.append(f"[{key}] nvcc exited {proc.returncode}:\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        libs = []
        for key in keys:
            if key not in _LOADED:
                _LOADED[key] = KernelLib(
                    root / key / "libsasa.so", key, logs.get(key, "")
                )
            libs.append(_LOADED[key])
        for spec, lib in zip(specs, libs):
            _BY_SPEC[spec] = lib
        return libs


build_many.compiles = 0


def get_kernel(spec: StencilSpec) -> KernelLib:
    """The loaded kernel for ``spec``, built at first use."""
    lib = _BY_SPEC.get(spec)
    return lib if lib is not None else build_many([spec])[0]


def is_loaded(key: str) -> bool:
    """Whether this process has loaded the library of kernel key ``key``."""
    return key in _LOADED


def export_library(spec: StencilSpec) -> tuple[str, bytes]:
    """``(kernel key, bytes of libsasa.so)`` for ``spec``, built first
    where missing."""
    lib = get_kernel(spec)
    return lib.key, lib.path.read_bytes()


def install_library(key: str, blob: bytes) -> KernelLib:
    """Write a library built elsewhere into ``BUILD_ROOT/<key>/`` and load
    it as the kernel of key ``key``; no ``nvcc`` runs.

    The write is atomic (tmp file + ``os.replace``), as a build's is.  A
    blob the dynamic loader refuses is removed again and raises
    :class:`OSError`, so a later :func:`build_many` rebuilds it.
    """
    with _LOCK:
        if key in _LOADED:
            return _LOADED[key]
        d = BUILD_ROOT / key
        d.mkdir(parents=True, exist_ok=True)
        so = d / "libsasa.so"
        tmp = d / f"libsasa.{os.getpid()}.so"
        tmp.write_bytes(blob)
        os.replace(tmp, so)
        try:
            lib = KernelLib(so, key)
        except (OSError, AttributeError) as e:
            so.unlink(missing_ok=True)
            raise OSError(f"kernel library {key} does not load: {e}") from e
        _LOADED[key] = lib
        return lib
