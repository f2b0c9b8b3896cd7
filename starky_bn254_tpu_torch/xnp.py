"""Array-namespace dispatcher: one constraint-evaluation code path, two
execution engines.

The polymorphic eval layer (goldilocks ops, `field_expr.Val`, the gadget and
AIR `eval` functions) is run by BOTH:

* the prover, over LDE row blocks held as int64 torch tensors on the
  trace's device (CPU or CUDA); and
* the verifier, which replays the identical constraints on a handful of
  extension scalars at zeta, as host numpy uint64 arrays.

Every function here dispatches per call: if any array argument is a
`torch.Tensor`, the torch implementation runs (numpy arguments are moved
onto that tensor's device first); otherwise numpy runs.

Storage convention: a field element is a canonical u64. Numpy holds it as
uint64; torch holds the same 64 bits as int64, because torch's CPU kernels
implement no uint64 add, compare or shift. Wrapping int64 add, sub and mul
produce the same bits as their uint64 counterparts, so only comparisons and
right shifts need care (goldilocks.py handles both). `to_torch` /
`to_numpy` reinterpret between the two without changing any bit.
"""

from __future__ import annotations

import numpy as _np
import torch

uint64 = _np.uint64
int64 = _np.int64


def to_torch(x, device=None) -> torch.Tensor:
    """numpy uint64 array (or anything numpy accepts) -> int64 tensor with
    the same bits, on `device` (default: CPU). No copy on the CPU."""
    a = _np.ascontiguousarray(_np.asarray(x, dtype=_np.uint64))
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a.view(_np.int64))
    return t if device is None else t.to(device)


def to_numpy(x) -> _np.ndarray:
    """int64 tensor (any device) or numpy array -> numpy uint64 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().numpy().view(_np.uint64)
    return _np.asarray(x, dtype=_np.uint64)


H2D_BYTES = 0  # bytes on_device / row_blocks copied from host memory to a card


def host_buffer(shape, device) -> torch.Tensor:
    """An uninitialised int64 host tensor for data a prove on `device`
    keeps off the card: pinned when the prove runs on a card, so each block
    it takes back to the card is one DMA copy."""
    return torch.empty(shape, dtype=torch.int64, pin_memory=torch.device(device).type == "cuda")


def _lies_on(x: torch.Tensor, device: torch.device) -> bool:
    return x.device.type == device.type and device.index in (None, x.device.index)


def on_device(x, device) -> torch.Tensor:
    """x itself when it lies on `device`, else a copy there (non-blocking
    from pinned memory). Copies from the host to a card count in H2D_BYTES.
    x may be a parallel.sharded.RowShards: its blocks are gathered there."""
    global H2D_BYTES
    device = torch.device(device)
    if not isinstance(x, torch.Tensor):
        return x.rows(0, x.shape[0], device)
    if _lies_on(x, device):
        return x
    if x.device.type == "cpu" and device.type == "cuda":
        H2D_BYTES += x.numel() * x.element_size()
    return x.to(device, non_blocking=x.is_pinned())


def row_blocks(mat, device, cells: int):
    """(r0, mat[r0:r1] on `device`) over mat's rows: the whole of mat once
    when it lies on `device`, else blocks of about `cells` cells, each
    copied there (an LDE offloaded to the host, or held in row shards, is
    read block by block by the consumer that needs it, never computed on
    where it lies)."""
    device = torch.device(device)
    if not isinstance(mat, torch.Tensor):  # a parallel.sharded.RowShards
        yield from mat.row_blocks(device, cells)
        return
    if _lies_on(mat, device):
        yield 0, mat
        return
    rows = max(cells // max(mat.shape[1], 1), 1)
    for r0 in range(0, mat.shape[0], rows):
        yield r0, on_device(mat[r0 : r0 + rows], device)


def take_rows(mat, idx: torch.Tensor) -> torch.Tensor:
    """mat's rows idx (a CPU int64 tensor), gathered where they lie: on
    mat's device, or on each row shard of a parallel.sharded.RowShards and
    brought to the host."""
    if not isinstance(mat, torch.Tensor):
        return mat.take(idx)
    return mat[idx.to(mat.device)]


_DEVICE_TABLES: dict[tuple, torch.Tensor] = {}


def device_table(key: tuple, device, make) -> torch.Tensor:
    """A host-built numpy uint64 constant, make(), cached as an int64 tensor
    per (key, device): twiddles, selectors and coset points are built once."""
    k = key + (str(device),)
    t = _DEVICE_TABLES.get(k)
    if t is None:
        t = to_torch(make(), device)
        _DEVICE_TABLES[k] = t
    return t


def as_tensor_like(x, ref: torch.Tensor) -> torch.Tensor:
    """Lift a numpy array / numpy scalar / Python int to an int64 tensor on
    `ref`'s device (values taken mod 2^64, same bits as uint64)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (bool, _np.bool_)) or (
        isinstance(x, _np.ndarray) and x.dtype == _np.bool_
    ):
        return torch.as_tensor(_np.asarray(x), device=ref.device)
    if isinstance(x, _np.ndarray) and x.dtype == _np.int64:
        return torch.from_numpy(_np.ascontiguousarray(x)).to(ref.device)
    if isinstance(x, _np.ndarray):
        return to_torch(x, ref.device)
    v = int(x) & ((1 << 64) - 1)
    if v >= 1 << 63:
        v -= 1 << 64
    return torch.tensor(v, dtype=torch.int64, device=ref.device)


def _first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


def _lift_all(args, ref):
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out.append(type(a)(_lift_all(a, ref)))
        elif isinstance(a, (_np.ndarray, _np.integer)):
            out.append(as_tensor_like(a, ref))
        else:
            out.append(a)
    return out


def _torch_pad(x, pad_width):
    flat = []
    for before, after in reversed(list(pad_width)):
        flat += [int(before), int(after)]
    return torch.nn.functional.pad(x, flat)


_TORCH = {
    "where": lambda c, a, b: torch.where(c, a, b),
    "stack": lambda xs, axis=0: torch.stack(list(xs), dim=axis),
    "concatenate": lambda xs, axis=0: torch.cat(list(xs), dim=axis),
    "zeros_like": torch.zeros_like,
    "ones_like": torch.ones_like,
    "pad": _torch_pad,
    "sum": lambda x, axis=None: x.sum() if axis is None else x.sum(dim=axis),
    "roll": lambda x, shift, axis=None: torch.roll(x, shift, dims=axis),
    "flip": lambda x, axis=None: torch.flip(
        x, dims=tuple(range(x.ndim)) if axis is None else (axis,)
    ),
    "broadcast_to": lambda x, shape: torch.broadcast_to(x, tuple(shape)),
}


def _dispatch(name):
    tf = _TORCH[name]
    nf = getattr(_np, name)

    def f(*args, **kwargs):
        ref = _first_tensor(args)
        if ref is not None:
            return tf(*_lift_all(args, ref), **kwargs)
        return nf(*args, **kwargs)

    f.__name__ = name
    return f


where = _dispatch("where")
stack = _dispatch("stack")
concatenate = _dispatch("concatenate")
zeros_like = _dispatch("zeros_like")
ones_like = _dispatch("ones_like")
pad = _dispatch("pad")
sum = _dispatch("sum")
roll = _dispatch("roll")
flip = _dispatch("flip")
broadcast_to = _dispatch("broadcast_to")


def asarray(x, dtype=None):
    """numpy-in -> numpy-out; tensor-in -> the same tensor. Explicitly NOT a
    device transfer: prover code creates device tensors itself."""
    if isinstance(x, torch.Tensor):
        return x
    return _np.asarray(x, dtype=dtype)


# no array input to dispatch on: numpy (a later op against a tensor lifts
# the result onto the tensor's device)
arange = _np.arange


def at_set(arr, idx, value):
    """arr.at[idx].set(value) on a copy, for both engines."""
    if isinstance(arr, torch.Tensor):
        out = arr.clone()
        out[idx] = as_tensor_like(value, arr)
        return out
    out = _np.array(arr, copy=True)
    out[idx] = value
    return out
