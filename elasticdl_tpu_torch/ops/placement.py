"""Embedding-gradient placement: kernel K1's wrapper and plain version.

`place_sorted_grads(sorted_ids, rows, num_rows)` returns the dense
(num_rows, D) float32 table whose row r is the sum of the `rows` whose id
is r; ids outside [0, num_rows) drop. It replaces
`elasticdl_tpu/ops/pallas_scatter.py:place_sorted_grads`, the Pallas TPU
kernel of the reference's embedding backward.

On a CUDA tensor it launches the hand-written kernels of
`csrc/place_sorted_grads.cu` (see the note there: K1 is bound by bytes —
~192 MB at the DeepFM shape, the dense 177 MB write dominating). A zero
pass writes the table's zeros with 16-byte stores and sums the fixed
chunks of hot segments into a scratch buffer this wrapper allocates; a
placement pass then writes the sum of each id's segment into its row,
a segment of SPLIT_ROWS or more rows summed by a whole block. The sums
are taken in a fixed order that does not change between runs (not stream
order), with no float atomics. It launches or raises: there is no
fallback. On a CPU tensor it runs `place_sorted_grads_plain`.

`launches` counts kernel launches (PASSES a call; not plain-version
calls), so a run can show that its main path went through the kernels.
The count is taken under a lock: the embedding tier's client pushes to
its shards from a thread pool.

The embedding backward calls it through the dispatcher op
`edl::place_sorted_grads` (`place_sorted_grads_op`), the kernel's
boundary for a counter that sees ops and not their bodies
(`Trainer.train_step_cost`): a placement sums rows, so the op has no
FLOP formula and counts none, and its bytes are the op's operands and
result, on the CPU as on the card.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from elasticdl_tpu_torch.ops import native

KERNEL = "place_sorted_grads"
PASSES = 2             # kernels a call launches: zero pass, placement
# as kSplit and kChunk of csrc/place_sorted_grads.cu: a segment of
# SPLIT_ROWS ids or more is summed by a whole block, and its full
# CHUNK_ROWS-aligned chunks by the zero pass
SPLIT_ROWS, CHUNK_ROWS = 32, 256
launches = 0
launches_lock = threading.Lock()

_INT_MAX = 2**31 - 1


def _validate(sorted_ids: torch.Tensor, rows: torch.Tensor,
              num_rows: int) -> None:
    if sorted_ids.dtype != torch.int32:
        raise TypeError(f"sorted_ids must be int32, got {sorted_ids.dtype}")
    if rows.dtype != torch.float32:
        raise TypeError(f"rows must be float32, got {rows.dtype}")
    if sorted_ids.dim() != 1 or rows.dim() != 2:
        raise ValueError(
            f"want sorted_ids (N,) and rows (N, D), got "
            f"{tuple(sorted_ids.shape)} and {tuple(rows.shape)}")
    if rows.shape[0] != sorted_ids.shape[0] or rows.shape[1] < 1:
        raise ValueError(
            f"rows {tuple(rows.shape)} do not match sorted_ids "
            f"{tuple(sorted_ids.shape)} (or D < 1)")
    if sorted_ids.device != rows.device:
        raise ValueError(
            f"sorted_ids on {sorted_ids.device}, rows on {rows.device}")
    if not 0 <= num_rows <= _INT_MAX or rows.shape[0] > _INT_MAX:
        raise ValueError(f"num_rows {num_rows} / N {rows.shape[0]} out of "
                         "the kernel's int32 range")


def place_sorted_grads_plain(sorted_ids: torch.Tensor, rows: torch.Tensor,
                             num_rows: int) -> torch.Tensor:
    """Plain PyTorch version: a masked `index_add_` in float32. Any id
    order is accepted."""
    ids = sorted_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < num_rows)
    out = torch.zeros((num_rows, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, ids[valid], rows[valid].to(torch.float32))


def place_sorted_grads(sorted_ids: torch.Tensor, rows: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Dense (num_rows, D) float32 gradient from an ascending int32 id
    stream and its (N, D) float32 rows in the same order."""
    global launches
    _validate(sorted_ids, rows, num_rows)
    if rows.device.type == "cpu":
        return place_sorted_grads_plain(sorted_ids, rows, num_rows)
    if rows.device.type != "cuda":
        raise ValueError(f"no kernel for device {rows.device}")
    if not (sorted_ids.is_contiguous() and rows.is_contiguous()):
        raise ValueError("sorted_ids and rows must be contiguous")
    n, d = rows.shape
    out = torch.empty((num_rows, d), dtype=torch.float32, device=rows.device)
    if num_rows == 0:
        return out
    lib = _library()
    scratch = torch.empty((lib.place_sorted_grads_scratch(n, d),),
                          dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = lib.place_sorted_grads(
            sorted_ids.data_ptr(), rows.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, num_rows, d, stream)
    native.check(lib, code, KERNEL)
    with launches_lock:
        launches += PASSES
    return out


@torch.library.custom_op("edl::place_sorted_grads", mutates_args=())
def place_sorted_grads_op(sorted_ids: torch.Tensor, rows: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """`place_sorted_grads` as the dispatcher op `edl::place_sorted_grads`:
    its body is the wrapper, so it launches K1 on the card and runs the
    plain version on the CPU."""
    return place_sorted_grads(sorted_ids, rows, num_rows)


@place_sorted_grads_op.register_fake
def _place_sorted_grads_fake(sorted_ids, rows, num_rows):
    del sorted_ids
    return rows.new_empty((num_rows, rows.shape[1]), dtype=torch.float32)


def _library() -> ctypes.CDLL:
    lib = native.load(KERNEL)
    fn = lib.place_sorted_grads
    if fn.argtypes is None:
        # c_void_p for every pointer and the stream: without argtypes
        # ctypes passes Python ints as 32-bit C ints and cuts pointers
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = lib.place_sorted_grads_scratch
        size.argtypes = [ctypes.c_int] * 2
        size.restype = ctypes.c_longlong
    return lib
