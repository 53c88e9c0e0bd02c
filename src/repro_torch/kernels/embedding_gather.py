"""The table-batched (TBE) gather+pool kernel: wrappers and plain versions.

One hand-written CUDA kernel, ``csrc/tbe_gather_pool.cu``, computes

    out[t, b, :] = sum_l w[t, b, l] * flat[off[t] + idx[t, b, l], :]

in f32 over a flat ``(N, D)`` f32 or bf16 row space, all T tables in one
launch.  Three wrappers mirror the three Pallas entry points of
``repro.kernels.embedding_gather``:

  * :func:`gather_pool_tbe_flat` -- ragged per-table row counts described
    by ``(T,)`` offsets: the tiered cache's ``(sum S_t, D)`` slot pool;
  * :func:`gather_pool_tbe` -- stacked ``(T, R, D)`` tables, the same
    kernel over the ``(T * R, D)`` view with ``off[t] = t * R``, passed as
    a stride and not as an array, so the call is one device kernel;
  * :func:`gather_pool` -- one ``(R, D)`` table, the kernel with ``T = 1``
    (the unfused per-table baseline launches it once per table).

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor takes the plain PyTorch version beside it (``*_ref``), a CUDA tensor
launches the kernel, anything else raises.  A kernel launch adds one to the
wrapper's entry in :data:`LAUNCH_COUNTS`; the plain versions count nothing.

Ids must lie in the table wherever the weight is non-zero; the kernel never
reads the row of a zero-weight slot.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import _pool_rows

LAUNCH_COUNTS = {"gather_pool": 0, "gather_pool_tbe": 0,
                 "gather_pool_tbe_flat": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _kernel():
    lib = _build.load("tbe_gather_pool")
    fn = lib.tbe_gather_pool
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, I, P, LL, P, P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        lib.tbe_error_string.argtypes = [I]
        lib.tbe_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the table on {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(flat: torch.Tensor, row_offsets: Optional[torch.Tensor],
            indices: torch.Tensor, weights: torch.Tensor,
            rows_per_table: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (T, B, D) f32.
    Table t starts at row ``row_offsets[t]``, or at ``t * rows_per_table``
    when ``row_offsets`` is None: then the launch is the only device work
    of the call."""
    device = flat.device
    if device.type != "cuda":
        raise ValueError(
            f"the TBE kernel runs on CUDA tensors (got {device}); CPU "
            f"tensors take the plain version")
    _check("flat_tables", flat, tuple(_DTYPE_CODES), 2, device)
    _check("indices", indices, torch.int32, 3, device)
    _check("weights", weights, torch.float32, 3, device)
    T, B, L = indices.shape
    D = flat.shape[1]
    if row_offsets is not None:
        _check("row_offsets", row_offsets, torch.int32, 1, device)
        if row_offsets.shape != (T,):
            raise ValueError(f"row_offsets must be (T,)=({T},), got "
                             f"{tuple(row_offsets.shape)}")
    if weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} != indices "
                         f"{tuple(indices.shape)}")
    out = torch.empty((T, B, D), dtype=torch.float32, device=device)
    vec = D % 4 == 0 and flat.data_ptr() % (4 * flat.element_size()) == 0
    lib = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.tbe_gather_pool(
            flat.data_ptr(), _DTYPE_CODES[flat.dtype],
            None if row_offsets is None else row_offsets.data_ptr(),
            rows_per_table, indices.data_ptr(), weights.data_ptr(),
            out.data_ptr(), T, B, L, D, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"tbe_gather_pool launch failed: "
                           f"{lib.tbe_error_string(rc).decode()} ({rc})")
    return out


# --- plain versions (what CPU tensors take) ---------------------------------

def gather_pool_tbe_flat_ref(flat_tables, row_offsets, indices, weights):
    """Plain ``gather_pool_tbe_flat``: (N, D) x (T, B, L) -> (T, B, D) f32."""
    rows = flat_tables[row_offsets.long()[:, None, None] + indices.long()]
    return _pool_rows(rows, None, weights, "sum", torch.float32)


def gather_pool_tbe_ref(tables, indices, weights):
    """Plain ``gather_pool_tbe``: (T, R, D) x (T, B, L) -> (T, B, D) f32."""
    t = torch.arange(tables.shape[0], device=tables.device)[:, None, None]
    return _pool_rows(tables[t, indices.long()], None, weights, "sum",
                      torch.float32)


def gather_pool_ref(table, indices, weights):
    """Plain ``gather_pool``: (R, D) x (B, L) -> (B, D) f32."""
    return _pool_rows(table[indices.long()], None, weights, "sum",
                      torch.float32)


# --- wrappers ---------------------------------------------------------------

def gather_pool_tbe_flat(flat_tables: torch.Tensor, row_offsets: torch.Tensor,
                         indices: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Fused pooled lookup over a FLAT ragged row space -> (T, B, D) f32.

    ``flat_tables`` (N, D) f32/bf16, ``row_offsets`` (T,) int32 start of
    each table's rows, ``indices`` (T, B, L) int32 table-local ids,
    ``weights`` (T, B, L) f32 with 0 on masked slots.  One launch."""
    if flat_tables.device.type == "cpu":
        return gather_pool_tbe_flat_ref(flat_tables, row_offsets, indices,
                                        weights)
    out = _launch(flat_tables, row_offsets, indices, weights)
    LAUNCH_COUNTS["gather_pool_tbe_flat"] += 1
    return out


def gather_pool_tbe(tables: torch.Tensor, indices: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Fused pooled lookup over stacked ``(T, R, D)`` tables -> (T, B, D)
    f32: the flat kernel over the ``(T * R, D)`` view with table t at row
    ``t * R``, one launch and no other device work."""
    if tables.device.type == "cpu":
        return gather_pool_tbe_ref(tables, indices, weights)
    T, R, D = tables.shape
    if indices.shape[0] != T:
        raise ValueError(f"tables T={T} != indices T={indices.shape[0]}")
    if not tables.is_contiguous():
        raise ValueError("tables must be contiguous")
    if T * R > torch.iinfo(torch.int32).max:
        raise ValueError(f"{T} x {R} rows overflow the int32 row offsets")
    out = _launch(tables.view(T * R, D), None, indices, weights,
                  rows_per_table=R)
    LAUNCH_COUNTS["gather_pool_tbe"] += 1
    return out


def gather_pool(table: torch.Tensor, indices: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Single-table pooled lookup, ``(R, D) x (B, L) -> (B, D)`` f32: the
    kernel with T = 1, one launch and no other device work."""
    if table.device.type == "cpu":
        return gather_pool_ref(table, indices, weights)
    if indices.dim() != 2:
        raise ValueError(f"indices must be (B, L), got {tuple(indices.shape)}")
    out = _launch(table, None, indices[None], weights[None])
    LAUNCH_COUNTS["gather_pool"] += 1
    return out[0]
