"""Wrappers for the CNN's 3x3 convolution kernels (``csrc/conv3x3.cu``,
which replaces no TPU kernel: the JAX package leaves its convolutions to
XLA).

Three kernels of one implicit-GEMM design on NHWC activations and HWIO
kernels, grouped over a leading axis G (each group with its own
weights), IEEE float32 throughout, each called through a plain function:

* :func:`conv3x3_fwd` — y = relu(conv(x, w) + b), stride 1, pad 1;
* :func:`conv3x3_dgrad` — dx from dy and the ReLU's output y (the mask
  y > 0 is applied as dy is loaded);
* :func:`conv3x3_wgrad` — dw (HWIO) and db from x, dy and y.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version (``ref.py``), in any floating
dtype. There is no fallback between the two. ``conv3x3_fwd.launches``,
``conv3x3_dgrad.launches`` and ``conv3x3_wgrad.launches`` count kernel
calls (a wgrad call's split-K reduction pass is part of that call), and
each call on the card adds 1 to the open round's ``conv_launches``
counter.

:func:`conv3x3_stack`, the CNN's convolution layers and their pools, is
one ``torch.autograd.Function`` over the whole stack with a vmap rule,
so that it composes with ``torch.func``: the pair step's
``vmap(grad(loss))`` makes one grouped call a layer (x and w batched:
the batch is the kernels' G), the eval's ``vmap(acc, in_dims=(None, 0,
0))`` one call a layer with G = 1 (only x batched: the batch folds into
the images), and a plain call runs with G = 1. Its backward, a second
Function with its own vmap rule, calls dgrad only where an input needs a
gradient.
"""
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.kernels import build
from repro_torch.kernels.conv3x3.ref import (conv3x3_dgrad_ref,
                                             conv3x3_fwd_ref,
                                             conv3x3_wgrad_ref)

Tensor = torch.Tensor

# The kernels' block tiles (rows BM x columns BN, TN columns a thread,
# BK deep), by the code the launchers take.
TILES = ((128, 128, 8, 8), (128, 64, 8, 8), (128, 32, 4, 16), (32, 32, 4, 8))
WAVE_BLOCKS = 1056    # wgrad splits its reduction until this many blocks
SLICE_MAX = 4096      # ... or until no slice sums more than this many rows
SLICE_MIN = 512       # ... but no slice sums fewer


def tile_for(rows: int, n: int) -> int:
    """The block tile (an index into TILES) for a product ``rows`` x
    ``n`` (per group): 128 rows by the narrowest of 128, 64 and 32
    columns that holds N (128 past it), and 32 x 32 for a product of
    at most 32 x 32 (the first layer's wgrad: 28 x 32)."""
    if n > 64:
        return 0
    if n > 32:
        return 1
    return 3 if rows <= 32 else 2


def _blocks(rows: int, n: int, tile: int) -> int:
    bm, bn = TILES[tile][:2]
    return -(-rows // bm) * -(-n // bn)


def wgrad_splits(G: int, rows: int, n: int, k: int) -> int:
    """Slices of the wgrad reduction (over k = N·H·W pixels) for G
    products of ``rows`` x ``n`` (rows = 9·Cin + 1, the bias row
    included): enough that the grid fills the card (WAVE_BLOCKS) and no
    slice sums more than SLICE_MAX pixels, but no slice fewer than
    SLICE_MIN. The slices are added in a fixed order by a second pass."""
    tiles = _blocks(rows, n, tile_for(rows, n)) * G
    want = max(-(-WAVE_BLOCKS // tiles), -(-k // SLICE_MAX))
    return max(1, min(want, k // SLICE_MIN))


@functools.lru_cache(maxsize=1)
def _kernels():
    lib = build.library("conv3x3")
    vp, i = ctypes.c_void_p, ctypes.c_int
    fwd, dgrad, wgrad = (lib.fedcd_conv3x3_fwd, lib.fedcd_conv3x3_dgrad,
                         lib.fedcd_conv3x3_wgrad)
    fwd.argtypes = [vp] * 4 + [i] * 7 + [vp]
    dgrad.argtypes = [vp] * 4 + [i] * 7 + [vp]
    wgrad.argtypes = [vp] * 6 + [i] * 8 + [vp]
    for fn in (fwd, dgrad, wgrad):
        fn.restype = ctypes.c_int
    return lib, fwd, dgrad, wgrad


def _device(*tensors: Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _require(t: Tensor, name: str, shape: Tuple[int, ...],
             dtype: torch.dtype) -> None:
    """Contiguous, of ``shape`` and ``dtype``, and 16-byte aligned on the
    card (the kernels' vector loads)."""
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got "
                         f"{t.dtype} contiguous={t.is_contiguous()}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.is_cuda and t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned")


def _dims(x: Tensor, name: str) -> Tuple[int, int, int, int, int]:
    """(G, N, H, W, C) of the activation that sets a call's pixel grid."""
    if x.dim() != 5 or min(x.shape) < 1:
        raise ValueError(f"{name}: expected (G, N, H, W, C), got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape)


def _check(dims, cin: int, cout: int, shapes: dict) -> torch.device:
    """The shared checks of a call on the pixel grid ``dims`` (G, N, H, W,
    C): Cout a multiple of 4 (the kernels load 4 output channels at a
    time), a group's activations indexable in 32 bits, and each of
    ``shapes`` (name: (tensor, shape)) contiguous, on one device and of
    one dtype: float32 on the card, any floating dtype on the CPU (the
    plain versions). Returns the device."""
    G, N, H, W, _ = dims
    if cout % 4 or cin < 1 or N * H * W * max(cin, cout) >= 2 ** 31:
        raise ValueError(f"unsupported shape {dims} with Cin {cin}, Cout "
                         f"{cout}")
    tensors = [t for t, _ in shapes.values()]
    device = _device(*tensors)
    dtype = torch.float32 if device.type == "cuda" else tensors[0].dtype
    if not dtype.is_floating_point:
        raise ValueError(f"unsupported dtype {dtype}")
    for name, (t, shape) in shapes.items():
        _require(t, name, shape, dtype)
    return device


def _launch(fn, *args) -> None:
    lib = _kernels()[0]
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, Tensor) else a for a in args]
        build.check_launch(lib, fn(*ptrs, stream), fn.__name__)
    telemetry.count("conv_launches")


def conv3x3_fwd(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x (G, N, H, W, Cin), w (G, 3, 3, Cin, Cout), b (G, Cout) ->
    y (G, N, H, W, Cout) = relu(conv(x[g], w[g]) + b[g])."""
    G, N, H, W, cin = dims = _dims(x, "x")
    cout = w.shape[-1]
    device = _check(dims, cin, cout, {"x": (x, dims),
                                      "w": (w, (G, 3, 3, cin, cout)),
                                      "b": (b, (G, cout))})
    if device.type == "cpu":
        return conv3x3_fwd_ref(x, w, b)
    y = torch.empty(G, N, H, W, cout, dtype=torch.float32, device=x.device)
    _launch(_kernels()[1], x, w, b, y, G, N, H, W, cin, cout,
            tile_for(N * H * W, cout))
    conv3x3_fwd.launches += 1
    return y


def conv3x3_dgrad(dy: Tensor, y: Tensor, w: Tensor) -> Tensor:
    """dy, y (G, N, H, W, Cout), w (G, 3, 3, Cin, Cout) -> dx (G, N, H, W,
    Cin): the input gradient of :func:`conv3x3_fwd`, whose output (after
    the ReLU) was y."""
    G, N, H, W, cout = dims = _dims(dy, "dy")
    cin = w.shape[3] if w.dim() == 5 else -1
    device = _check(dims, cin, cout, {"dy": (dy, dims), "y": (y, dims),
                                      "w": (w, (G, 3, 3, cin, cout))})
    if device.type == "cpu":
        return conv3x3_dgrad_ref(dy, y, w)
    dx = torch.empty(G, N, H, W, cin, dtype=torch.float32, device=dy.device)
    _launch(_kernels()[2], dy, y, w, dx, G, N, H, W, cin, cout,
            tile_for(N * H * W, cin))
    conv3x3_dgrad.launches += 1
    return dx


def conv3x3_wgrad(x: Tensor, dy: Tensor, y: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """x (G, N, H, W, Cin), dy, y (G, N, H, W, Cout) -> dw (G, 3, 3, Cin,
    Cout), db (G, Cout): the weight and bias gradients of
    :func:`conv3x3_fwd`, whose output (after the ReLU) was y."""
    G, N, H, W, cin = dims = _dims(x, "x")
    cout = dy.shape[-1]
    out = (G, N, H, W, cout)
    device = _check(dims, cin, cout, {"x": (x, dims), "dy": (dy, out),
                                      "y": (y, out)})
    if device.type == "cpu":
        return conv3x3_wgrad_ref(x, dy, y)
    f32 = dict(dtype=torch.float32, device=x.device)
    dw = torch.empty(G, 3, 3, cin, cout, **f32)
    db = torch.empty(G, cout, **f32)
    rows = 9 * cin + 1
    splits = wgrad_splits(G, rows, cout, N * H * W)
    ws = torch.empty(splits, G, rows, cout, **f32) if splits > 1 else dw
    _launch(_kernels()[3], x, dy, y, dw, db, ws, splits, G, N, H, W, cin,
            cout, tile_for(rows, cout))
    conv3x3_wgrad.launches += 1
    return dw, db


conv3x3_fwd.launches = 0
conv3x3_dgrad.launches = 0
conv3x3_wgrad.launches = 0


# --- the convolution stack: autograd and vmap rules ---------------------

def _pool(y: Tensor) -> Tuple[Tensor, Tensor]:
    """2x2 max-pool of y (G, N, H, W, C) on its channels-last view:
    the pooled (G, N, H/2, W/2, C) and the pool's indices, both NHWC
    (the layout max-pool gives a channels-last input; no copy)."""
    G, N, H, W, C = y.shape
    p, idx = F.max_pool2d(y.view(G * N, H, W, C).permute(0, 3, 1, 2), 2,
                          return_indices=True)
    shape = (G, N, H // 2, W // 2, C)
    return (p.permute(0, 2, 3, 1).reshape(shape),
            idx.permute(0, 2, 3, 1).reshape(shape))


def _nchw_view(t: Tensor) -> Tensor:
    """(G, N, H, W, C) -> its channels-last (G*N, C, H, W) view."""
    return t.flatten(0, 1).permute(0, 3, 1, 2)


def _unpool(dp: Tensor, y: Tensor, idx: Tensor) -> Tensor:
    """The gradient of :func:`_pool` at y, given the pooled's dp."""
    dy = torch.ops.aten.max_pool2d_with_indices_backward(
        _nchw_view(dp), _nchw_view(y), [2, 2], [2, 2], [0, 0], [1, 1],
        False, _nchw_view(idx))
    return dy.permute(0, 2, 3, 1).reshape(y.shape)


def _forward(x: Tensor, ws, bs, pools, keep: bool):
    """The stack on (G, ...) tensors: its output and, when ``keep``, what
    its backward reads besides the output, in order: each layer's
    post-ReLU y (but the last layer's when it is the output), and after
    a pooled layer its pool's indices and (but for the last layer) the
    pooled activation, the next layer's input."""
    saved = []
    for w, b, pool in zip(ws, bs, pools):
        y = x = conv3x3_fwd(x, w, b)
        if pool:
            x, idx = _pool(y)
        if keep:
            saved += [y, idx, x] if pool else [y]
    return x, saved[:-1]             # the last is the output itself


def _backward(dout: Tensor, out: Tensor, x: Tensor, ws, saved, pools,
              need_x: bool):
    """dx (None unless ``need_x``), dws, dbs of the stack from the
    gradient of its output ``out``."""
    ys, idxs, inputs = [], [], [x]
    it, last = iter(saved), len(pools) - 1
    for i, pool in enumerate(pools):
        ys.append(out if i == last and not pool else next(it))
        idxs.append(next(it) if pool else None)
        if i < last:
            inputs.append(next(it) if pool else ys[-1])
    L = len(ws)
    dws, dbs, d = [None] * L, [None] * L, dout
    for i in reversed(range(L)):
        dy = _unpool(d, ys[i], idxs[i]) if pools[i] else d
        dws[i], dbs[i] = conv3x3_wgrad(inputs[i], dy, ys[i])
        d = conv3x3_dgrad(dy, ys[i], ws[i]) if i or need_x else None
    return d, dws, dbs


class _Stack(torch.autograd.Function):
    """(x, pools, keep, *ws, *bs) -> (out, *saved) on (G, ...) tensors."""

    @staticmethod
    def forward(x, pools, keep, *wb):
        out, saved = _forward(x, wb[:len(pools)], wb[len(pools):], pools,
                              keep)
        return (out, *saved)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, pools, keep, *wb = inputs
        ctx.pools = pools
        ctx.set_materialize_grads(False)
        if keep:
            ctx.mark_non_differentiable(*output[1:])
            ctx.save_for_backward(output[0], x, *wb[:len(pools)],
                                  *output[1:])

    @staticmethod
    def backward(ctx, dout, *_):
        grads = _StackGrad.apply(dout.contiguous(), ctx.pools,
                                 ctx.needs_input_grad[0], *ctx.saved_tensors)
        return (grads[0], None, None, *grads[1:])

    @staticmethod
    def vmap(info, in_dims, x, pools, keep, *wb):
        n = info.batch_size
        xd, wbd = in_dims[0], in_dims[3:]
        if all(d is None for d in wbd):
            outs = _Stack.apply(_folded(x, xd, n), pools, keep, *wb)
            return tuple(o.unflatten(1, (n, -1)) for o in outs), \
                (1,) * len(outs)
        outs = _Stack.apply(_grouped(x, xd, n), pools, keep,
                            *(_grouped(t, d, n) for t, d in zip(wb, wbd)))
        return tuple(o.unflatten(0, (n, -1)) for o in outs), (0,) * len(outs)


class _StackGrad(torch.autograd.Function):
    """(dout, pools, need_x, out, x, *ws, *saved) -> (dx or None, *dws,
    *dbs)."""

    @staticmethod
    def forward(dout, pools, need_x, out, x, *rest):
        L = len(pools)
        dx, dws, dbs = _backward(dout, out, x, rest[:L], rest[L:], pools,
                                 need_x)
        return (dx, *dws, *dbs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, dout, pools, need_x, *rest):
        n = info.batch_size
        dims = (in_dims[0], *in_dims[3:])
        dout, *rest = (_grouped(t, d, n)
                       for t, d in zip((dout, *rest), dims))
        outs = _StackGrad.apply(dout, pools, need_x, *rest)
        return (tuple(None if o is None else o.unflatten(0, (n, -1))
                      for o in outs),
                tuple(None if o is None else 0 for o in outs))


def _batched(t: Tensor, dim: Optional[int], batch: int) -> Tensor:
    """An operand under vmap with its batch dim first (an unbatched one
    repeated ``batch`` times, as a view)."""
    return t.movedim(dim, 0) if dim is not None else t.expand(batch, *t.shape)


def _grouped(t: Tensor, dim: Optional[int], batch: int) -> Tensor:
    """A (G, ...) operand under vmap -> (batch·G, ...), contiguous: the
    batch becomes groups."""
    return _batched(t, dim, batch).flatten(0, 1).contiguous()


def _folded(t: Tensor, dim: Optional[int], batch: int) -> Tensor:
    """A (G, N, ...) activation under vmap whose weights are not batched
    -> (G, batch·N, ...), contiguous: the batch becomes images."""
    return _batched(t, dim, batch).movedim(0, 1).flatten(1, 2).contiguous()


def conv3x3_stack(x: Tensor, weights: Sequence[Tensor],
                  biases: Sequence[Tensor], pools: Sequence[bool]) -> Tensor:
    """The CNN's convolution layers: x (N, H, W, C0) through layer i =
    relu(conv(·, weights[i]) + biases[i]) (HWIO weights, stride 1, pad
    1), each followed by a 2x2 max-pool where ``pools[i]``; NHWC out.

    Differentiable, and batched by ``torch.func.vmap``: with the weights
    batched (the pair step's ``vmap(grad(loss))``) the batch is the
    kernels' group axis G; with only x batched (the eval's ``vmap(acc,
    in_dims=(None, 0, 0))``) it folds into the images, G = 1. The
    backward launches dgrad only where an input needs a gradient (not
    for the images into the first layer). One autograd function covers
    the whole stack: functorch runs an autograd.Function's rules in
    Python, some hundreds of microseconds of host time per call, once
    per step here rather than once per layer. What the backward reads
    (each layer's post-ReLU output and pool indices, the pooled inputs)
    is kept only while autograd records."""
    pools = tuple(bool(p) for p in pools)
    if not len(weights) == len(biases) == len(pools) >= 1:
        raise ValueError(f"{len(weights)} weights, {len(biases)} biases "
                         f"and {len(pools)} pool flags")
    wb = [t.contiguous()[None] for t in (*weights, *biases)]
    keep = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in wb))
    return _Stack.apply(x.contiguous()[None], pools, keep, *wb)[0][0]
