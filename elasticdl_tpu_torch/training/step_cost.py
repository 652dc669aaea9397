"""The FLOPs and bytes of the ops a piece of code dispatches:
`Trainer.train_step_cost`'s counter.

Counterpart of the reference's XLA cost analysis of its lowered step
(`elasticdl_tpu/training/trainer.py:train_step_cost`), with one
difference of design: the FLOPs are the products only (matmuls,
convolutions, attention), the MFU numerator the reference's docstring
describes, where XLA's figure adds every elementwise op.

- FLOPs: each matmul (`mm`, `addmm`, `bmm`, `baddbmm`) and the flash
  ops (`edl::flash_fwd`, `edl::flash_bwd`) by the formula
  `torch.utils.flop_counter` holds for it, K1's op
  (`edl::place_sorted_grads`, a sum of rows) none; each convolution by
  `conv_flops`, which counts only the multiply-adds of real input
  positions, as XLA counts a convolution (the padding and the holes of a
  dilation add none), so that a convolution, its input gradient and its
  kernel gradient count the same. A hand-written op counts at its
  boundary: the counter does not see its body, which is the plain
  version on the CPU and a ctypes launch on the card, so the count does
  not depend on the device.
- Bytes: each dispatched op's operands read once and its results written
  once, an in-place op's tensor both; views and allocations move none.
  Like the reference's 'bytes accessed' before fusion, this is an upper
  bound on the device memory traffic: a kernel that fuses ops keeps
  their intermediates out of memory.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_ATEN = torch.ops.aten
# ops that only describe memory: `_unsafe_view` returns a view without
# saying so, and the allocations write nothing
_MOVE_NOTHING = {_ATEN._unsafe_view, _ATEN.empty, _ATEN.empty_like,
                 _ATEN.empty_strided, _ATEN.new_empty,
                 _ATEN.new_empty_strided}


def _taps(positions: int, bound: int, kernel: int, stride: int, pad: int,
          dilation: int) -> int:
    """The (position, kernel tap) pairs of one spatial dimension whose
    other end, position * stride + tap * dilation - pad, lies in
    [0, bound)."""
    count = 0
    for tap in range(kernel):
        offset = tap * dilation - pad
        first = max(0, -(offset // stride))
        last = min(positions - 1, (bound - 1 - offset) // stride)
        count += max(0, last - first + 1)
    return count


def conv_flops(x_shape: Sequence[int], w_shape: Sequence[int],
               out_shape: Sequence[int], stride: Sequence[int],
               padding: Sequence[int], dilation: Sequence[int],
               transposed: bool) -> int:
    """2 x the multiply-adds of a convolution over x (N, C, *spatial) with
    the weight (C_out, C_in / groups, *kernel) (transposed: (C_in,
    C_out / groups, *kernel)) into out: for each spatial dimension the
    (output position, tap) pairs that read a real input position
    (`_taps`; a transposed convolution's input position writes a real
    output position)."""
    flops = 2 * x_shape[0] * w_shape[0] * w_shape[1]
    for i, kernel in enumerate(w_shape[2:]):
        size_in, size_out = x_shape[2 + i], out_shape[2 + i]
        positions, bound = ((size_in, size_out) if transposed
                            else (size_out, size_in))
        flops *= _taps(positions, bound, kernel, stride[i], padding[i],
                       dilation[i])
    return flops


def _convolution(x, w, _bias, stride, padding, dilation, transposed,
                 *_rest, out):
    return conv_flops(x.shape, w.shape, out.shape, stride, padding,
                      dilation, transposed)


def _convolution_backward(grad_out, x, w, _bias_sizes, stride, padding,
                          dilation, transposed, _output_padding, _groups,
                          output_mask, out):
    # the input's and the kernel's gradients each take the forward's
    # multiply-adds; the bias's is a sum
    del out
    once = conv_flops(x.shape, w.shape, grad_out.shape, stride, padding,
                      dilation, transposed)
    return once * (int(output_mask[0]) + int(output_mask[1]))


_CONV_FLOPS = {_ATEN.convolution: _convolution,
               _ATEN.convolution_backward: _convolution_backward}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class StepCost(TorchDispatchMode):
    """Counts `flops` and `bytes` (module docstring) of every op
    dispatched while it is active, the backward's included."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in _CONV_FLOPS:
            self.flops += _CONV_FLOPS[packet](*args, **kwargs, out=out)
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not (func.is_view or packet in _MOVE_NOTHING
                or torch.Tag.inplace_view in func.tags):
            self.bytes += (_nbytes(_tensors((args, kwargs)))
                           + _nbytes(_tensors(out)))
        return out
