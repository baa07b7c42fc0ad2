"""Generate, build and load the CUDA tile kernel for a lowered spec.

The tile kernel is hand-written in ``csrc/stencil_tile.cuh``; only the
expressions depend on the spec.  :func:`generate` turns every stage of a
lowered :class:`~repro_torch.core.spec.StencilSpec` (``Let``/``Var``/
``BinOp``/``Call``/``Neg``/``Num``/``Ref``) into device code in
``spec_body.cuh`` and writes a translation unit that sets the spec's
constants and includes the template.  Nothing else goes into a build.

Every stage is a ``sasa_stage<k>`` function of one cell, reading each tap
from shared memory.  A 2-D or 3-D stage is also a ``sasa_strip<k>`` that
computes a strip of ``SASA_STRIP`` cells along the outermost real axis
(``repro_torch.kernels.tiling.STRIP_CELLS``): it loads each of the
stage's columns (:func:`~repro_torch.kernels.tiling.tap_columns`) once
into registers, and each tap of a cell reads a register.  The
expression, its taps and the order of its operations are the same in
both forms.

Build (route (b): a plain C entry point loaded with ``ctypes``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -fmad=false -prec-div=true -prec-sqrt=true \\
         -ftz=false -I csrc -I <build dir> kernel.cu -o libsasa.so

``-fmad=false`` keeps one rounding per operation.  A division is
RN(x / d), bitwise what IEEE division gives: a division by a constant
``Num`` that :func:`~repro_torch.kernels.division.lower_division` admits
is emitted as a multiply by its exact reciprocal or as the correction
sequence (``__fmul_rn``, ``__fmaf_rn``, ``fminf``) with no branch, any
other as C ``/`` under ``-prec-div=true``.  A ``Num`` is emitted as the
exact float32 value of ``np.float32(value)`` as a hex-float literal (a
decimal literal could round twice).  bfloat16 specs compute in float and
round to bfloat16 where a stage writes.

The shared library is cached by a hash of the generated sources, the
template sources in ``csrc/`` and the flags, under
``build/repro_torch_kernels/<key>/`` at the root of the checkout.  Grid
shape, tile, halo and fusion depth are launch arguments, so one build
serves every shape and depth of a spec's structure.  :func:`build_many`
starts one ``nvcc`` per missing library, at most ``2 * os.cpu_count()``
at once, and counts each compile on ``build_many.compiles``.

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
from concurrent.futures import ThreadPoolExecutor
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
from repro_torch.kernels.division import Division, lower_division
from repro_torch.kernels.tiling import (
    STRIP_CELLS,
    float_inputs,
    frame_width,
    index_inputs,
    stage_tails,
    tap_columns,
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


FLT_MAX = float_literal(np.finfo(np.float32).max)


def _offsets3(offsets) -> tuple[int, int, int]:
    """A tap's offsets on the kernel's three axes (leading axes 0)."""
    return (0,) * (3 - len(offsets)) + tuple(int(o) for o in offsets)


class _Emitter:
    """One stage's expression as C++.  At one cell (``sasa_stage``) a tap
    reads shared memory through ``sasa_tap`` and a ``Let`` binding is a
    local.  Over a strip (``columns`` given, ``sasa_strip``) a tap of cell
    ``r`` reads register ``t<j>[r + offset - lo]`` of its column ``j``,
    and each operation, in the order a cell evaluates them, is a register
    array ``n<i>`` computed for every cell of the strip before the next
    operation: each cell's operations and operands are the same, only the
    interleaving of the cells differs."""

    def __init__(self, buffers: dict[str, int], columns=None):
        self.buffers = buffers
        self.columns = None if columns is None else {
            (col.name, col.inner): (j, col.lo) for j, col in enumerate(columns)
        }
        self.lines: list[str] = []
        self.n_vars = 0

    def op(self, value: str) -> str:
        """An operation's result: inline at one cell, an array over a strip."""
        if self.columns is None:
            return value
        name = f"n{self.n_vars}"
        self.n_vars += 1
        self.lines += [
            f"    float {name}[SASA_STRIP];",
            "#pragma unroll",
            f"    for (int r = 0; r < SASA_STRIP; ++r) {name}[r] = {value};",
        ]
        return f"{name}[r]"

    def bind(self, value: str) -> str:
        """A ``Let`` binding: a local at one cell; over a strip the value is
        already an array or a leaf."""
        if self.columns is not None:
            return value
        var = f"v{self.n_vars}"
        self.n_vars += 1
        self.lines.append(f"  const float {var} = {value};")
        return var

    def divide(self, x: str, d: str, how: Division) -> str:
        """``x / d`` as ``how`` lowers it (:mod:`repro_torch.kernels.division`),
        each operation of the correction its own operation over a strip."""
        if how.kind == "ieee":
            return self.op(f"({x} / {d})")
        y = float_literal(how.reciprocal)
        if how.kind == "reciprocal":
            return self.op(f"__fmul_rn({x}, {y})")
        x = self.bind(x)
        q = self.bind(self.op(f"__fmul_rn({x}, {y})"))
        signed_x = f"(-{x})" if how.divisor > 0 else x
        e = self.op(f"__fmaf_rn({float_literal(abs(how.divisor))}, {q}, {signed_x})")
        e = self.op(f"fminf({e}, {FLT_MAX})")
        return self.op(f"__fmaf_rn({float_literal(-abs(how.reciprocal))}, {e}, {q})")

    def expr(self, e: Expr, env: dict[str, str]) -> str:
        if isinstance(e, Num):
            return float_literal(e.value)
        if isinstance(e, Ref):
            if self.columns is not None:
                offs = tuple(int(o) for o in e.offsets)
                j, lo = self.columns[(e.name, (0,) + offs[1:])]
                return f"t{j}[r + {offs[0] - lo}]"
            offs = _offsets3(e.offsets)
            return (
                f"sasa_tap<{offs[0]}, {offs[1]}, {offs[2]}>"
                f"(env[{self.buffers[e.name]}], c, g)"
            )
        if isinstance(e, Var):
            return env[e.name]
        if isinstance(e, Let):
            env = dict(env)
            for name, bound in e.bindings:
                env[name] = self.bind(self.expr(bound, env))
            return self.expr(e.body, env)
        if isinstance(e, Neg):
            return self.op(f"(-{self.expr(e.arg, env)})")
        if isinstance(e, BinOp):
            if e.op not in "+-*/":
                raise ValueError(f"unknown op {e.op!r}")
            lhs = self.expr(e.lhs, env)
            rhs = self.expr(e.rhs, env)
            if e.op == "/":
                return self.divide(lhs, rhs, lower_division(e.rhs))
            return self.op(f"({lhs} {e.op} {rhs})")
        if isinstance(e, Call):
            args = [self.expr(a, env) for a in e.args]
            if e.fn == "abs":
                return self.op(f"fabsf({args[0]})")
            acc = args[0]
            for a in args[1:]:
                acc = self.op(f"sasa_{e.fn}({acc}, {a})")
            return acc
        raise TypeError(f"cannot emit expression node {e!r}")


def _flat_stage(k: int, expr: Expr, buffers: dict[str, int]) -> list[str]:
    """``sasa_stage<k>``: the stage at the cell of flat index ``c``."""
    em = _Emitter(buffers)
    result = em.expr(expr, {})
    return [
        "template <>",
        f"__device__ __forceinline__ float sasa_stage<{k}>(",
        "    const float* const* env, int c, const SasaGeom& g) {",
        *em.lines,
        f"  return {result};",
        "}",
    ]


def _strip_stage(k: int, expr: Expr, buffers: dict[str, int]) -> list[str]:
    """``sasa_strip<k>::run``: the stage at the ``SASA_STRIP`` cells of a
    strip from the cell of flat index ``c``, ``w`` floats apart, into
    ``v``, each tap column loaded once."""
    columns = tap_columns(expr)
    em = _Emitter(buffers, columns)
    result = em.expr(expr, {})
    loads = []
    for j, col in enumerate(columns):
        o = _offsets3((col.lo,) + col.inner[1:])
        loads += [
            f"    float t{j}[SASA_STRIP + {col.hi - col.lo}];",
            f"    sasa_column(t{j}, sasa_at<{o[0]}, {o[1]}, {o[2]}>"
            f"(env[{buffers[col.name]}], c, g), w);",
        ]
    return [
        "template <>",
        f"struct sasa_strip<{k}> {{",
        "  static __device__ __forceinline__ void run(",
        "      const float* const* env, int c, int w, const SasaGeom& g,",
        "      float (&v)[SASA_STRIP]) {",
        *loads,
        *em.lines,
        "#pragma unroll",
        f"    for (int r = 0; r < SASA_STRIP; ++r) v[r] = {result};",
        "  }",
        "};",
    ]


def generate(spec: StencilSpec) -> tuple[str, str]:
    """``(kernel.cu, spec_body.cuh)`` sources for a lowered spec."""
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
        body += _flat_stage(k, st.expr, buffers)
        if spec.ndim > 1:
            body += _strip_stage(k, st.expr, buffers)
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
        f"#define SASA_STRIP {STRIP_CELLS[spec.ndim]}",
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

    One ``nvcc`` process is started per missing library, at most
    ``2 * os.cpu_count()`` running at once (each takes hundreds of MB),
    and each is awaited.  A failed build raises with the compiler's
    output.  ``ptxas_info`` adds ``-Xptxas -v`` and keeps the compiler's
    report on ``KernelLib.build_log``.
    """
    root = BUILD_ROOT
    with _LOCK:
        keys = [kernel_key(s) for s in specs]
        todo = {}
        for spec, key in zip(specs, keys):
            if key in _LOADED or key in todo:
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
            todo[key] = (cmd, tmp, so)
        logs = {}
        failed = []
        jobs = max(1, min(2 * (os.cpu_count() or 1), len(todo)))
        with ThreadPoolExecutor(jobs) as pool:
            done = list(pool.map(
                lambda job: subprocess.run(
                    job[0], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True),
                todo.values()))
        for (key, (_, tmp, so)), proc in zip(todo.items(), done):
            logs[key] = proc.stdout
            build_many.compiles += 1
            if proc.returncode != 0:
                failed.append(
                    f"[{key}] nvcc exited {proc.returncode}:\n{proc.stdout}")
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
