"""Plain PyTorch versions of the 3x3 convolution kernels
(``csrc/conv3x3.cu``): the CNN's F.conv2d formulation, with its permutes.

Activations are NHWC and kernels HWIO, the bank's layout; a stride-1,
pad-1 3x3 convolution with its bias and ReLU:

x (N, H, W, Cin), w (3, 3, Cin, Cout), b (Cout,) ->
    y (N, H, W, Cout) = relu(conv(x, w) + b)            (conv3x3_ref)

The grouped forms take a leading group axis G on every tensor, each
group with its own weights, and compute what ``torch.func.vmap`` of
:func:`conv3x3_ref` computes, as functorch's batching rules lower it:
one grouped F.conv2d of G groups on the channels of an NCHW tensor
(with G > 1, the bias added after it, and its gradient summed from the
output's), and the same grouped convolution's backward
(``aten.convolution_backward``). With G = 1 the bias goes into F.conv2d,
as in :func:`conv3x3_ref`. The gradients take the ReLU's mask from the
output y (``threshold_backward``, as ``torch.relu``'s backward does):

x (G, N, H, W, Cin), w (G, 3, 3, Cin, Cout), b (G, Cout) ->
    y (G, N, H, W, Cout)                                 (conv3x3_fwd_ref)
dy, y (G, N, H, W, Cout), w -> dx (G, N, H, W, Cin)      (conv3x3_dgrad_ref)
x, dy, y -> dw (G, 3, 3, Cin, Cout), db (G, Cout)        (conv3x3_wgrad_ref)
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_CONV = dict(stride=[1, 1], padding=[1, 1], dilation=[1, 1],
             transposed=False, output_padding=[0, 0])


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """One convolution layer of the CNN: NHWC in, NHWC out."""
    y = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                            b, padding=1))
    return y.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(G, N, H, W, C) -> (N, G*C, H, W), group-major channels."""
    G, N, H, W, C = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(N, G * C, H, W)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """(G, 3, 3, Cin, Cout) -> (G*Cout, Cin, 3, 3)."""
    G, kh, kw, ci, co = w.shape
    return w.permute(0, 4, 3, 1, 2).reshape(G * co, ci, kh, kw)


def _gnchw(t: torch.Tensor, G: int) -> torch.Tensor:
    """(N, G*C, H, W) -> (G, N, C, H, W), a view."""
    N, GC, H, W = t.shape
    return t.reshape(N, G, GC // G, H, W).movedim(1, 0)


def _nhwc(t: torch.Tensor, G: int) -> torch.Tensor:
    """(N, G*C, H, W) -> contiguous (G, N, H, W, C)."""
    return _gnchw(t, G).permute(0, 1, 3, 4, 2).contiguous()


def conv3x3_fwd_ref(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    G = x.shape[0]
    if G == 1:
        y = F.conv2d(_nchw(x), _oihw(w), b.reshape(-1), padding=1)
        return _nhwc(torch.relu(y), 1)
    y = F.conv2d(_nchw(x), _oihw(w), None, padding=1, groups=G)
    y = _gnchw(y, G) + b[:, None, :, None, None]
    return torch.relu(y).permute(0, 1, 3, 4, 2).contiguous()


def conv3x3_dgrad_ref(dy: torch.Tensor, y: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    G, N, H, W, _ = dy.shape
    g = torch.ops.aten.threshold_backward(dy, y, 0)
    wt = _oihw(w)
    # the input's shape (and, with G = 1, its layout: x's channels-last
    # view) as autograd's convolution_backward sees it
    like = dict(dtype=dy.dtype, device=dy.device)
    dummy = torch.zeros((), **like).expand(N, G * w.shape[3], H, W)
    if G == 1:
        dummy = torch.empty(N, H, W, w.shape[3], **like).permute(0, 3, 1, 2)
    dx = torch.ops.aten.convolution_backward(
        _nchw(g), dummy, wt, None, groups=G,
        output_mask=[True, False, False], **_CONV)[0]
    return _nhwc(dx, G)


def conv3x3_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    G, _, _, _, ci = x.shape
    co = dy.shape[-1]
    g = torch.ops.aten.threshold_backward(dy, y, 0)
    dummy = torch.zeros((), dtype=x.dtype, device=x.device).expand(
        G * co, ci, 3, 3)
    g = _nchw(g)
    _, dw, db = torch.ops.aten.convolution_backward(
        g, _nchw(x), dummy, [G * co], groups=G,
        output_mask=[False, True, G == 1], **_CONV)
    if G > 1:
        db = _gnchw(g, G).sum((1, 3, 4))
    dw = dw.reshape(G, co, ci, 3, 3).permute(0, 3, 4, 2, 1).contiguous()
    return dw, db.reshape(G, co)
