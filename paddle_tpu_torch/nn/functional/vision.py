"""Vision functionals — port of `paddle_tpu/nn/functional/vision.py`
(reference `python/paddle/nn/functional/vision.py`).

`grid_sample` is the reference's own sampler written out, not
`F.grid_sample`: "nearest" rounds half to even (`jnp.round`, as
`torch.round` does) and, under "zeros", keeps a sample whose continuous
position lies in [0, size - 1]; "border" clamps the position first; any
other padding mode ("reflection") falls through to clamping the indices.
`affine_grid` builds 4-D grids only and raises for 5-D, as the reference
does.
"""
from __future__ import annotations

import torch

from ...core.tensor import apply


class _ZeroGradTo(torch.autograd.Function):
    """`out` as it is, with `src` given a zero gradient: the reference's
    tape gives the grid of a "nearest" sample zeros (its rounding passes
    no gradient), where torch would give it none."""

    @staticmethod
    def forward(ctx, out, src):
        ctx.like = (src.shape, src.dtype, src.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            out = a.reshape(n, c // (r * r), r, r, h, w)
            out = out.permute(0, 1, 4, 2, 5, 3)
            return out.reshape(n, c // (r * r), h * r, w * r)
        n, h, w, c = a.shape
        out = a.reshape(n, h, w, r, r, c // (r * r))
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h * r, w * r, c // (r * r))
    return apply("pixel_shuffle", f, x)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            out = a.reshape(n, c, h // r, r, w // r, r)
            out = out.permute(0, 1, 3, 5, 2, 4)
            return out.reshape(n, c * r * r, h // r, w // r)
        n, h, w, c = a.shape
        out = a.reshape(n, h // r, r, w // r, r, c)
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h // r, w // r, c * r * r)
    return apply("pixel_unshuffle", f, x)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def f(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            out = a.reshape(n, groups, c // groups, h, w)
            out = out.permute(0, 2, 1, 3, 4)
            return out.reshape(n, c, h, w)
        n, h, w, c = a.shape
        out = a.reshape(n, h, w, groups, c // groups)
        out = out.permute(0, 1, 2, 4, 3)
        return out.reshape(n, h, w, c)
    return apply("channel_shuffle", f, x)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    def f(th):
        if len(out_shape) == 4:
            _, _, h, w = out_shape
            dev = th.device
            if align_corners:
                ys = torch.linspace(-1, 1, h, device=dev)
                xs = torch.linspace(-1, 1, w, device=dev)
            else:
                ys = (torch.arange(h, device=dev) + 0.5) * 2 / h - 1
                xs = (torch.arange(w, device=dev) + 0.5) * 2 / w - 1
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
            return torch.einsum("hwk,nck->nhwc", base.to(th.dtype), th)
        raise NotImplementedError("5-D affine_grid")
    return apply("affine_grid", f, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    def f(a, g):
        n, c, h, w = a.shape
        gx, gy = g[..., 0], g[..., 1]
        if align_corners:
            fx = (gx + 1) * (w - 1) / 2
            fy = (gy + 1) * (h - 1) / 2
        else:
            fx = ((gx + 1) * w - 1) / 2
            fy = ((gy + 1) * h - 1) / 2
        if padding_mode == "border":
            fy = torch.clamp(fy, 0, h - 1)
            fx = torch.clamp(fx, 0, w - 1)
        batch = torch.arange(n, device=a.device).reshape(n, 1, 1)

        def at(yi, xi):
            # img[:, yc, xc] of every batch row: [N, Ho, Wo, C] -> [N, C, ...]
            yc = torch.clamp(yi, 0, h - 1)
            xc = torch.clamp(xi, 0, w - 1)
            return a.permute(0, 2, 3, 1)[batch, yc, xc].permute(0, 3, 1, 2)

        if mode == "nearest":
            out = at(torch.round(fy).to(torch.int32),
                     torch.round(fx).to(torch.int32))
            if padding_mode == "zeros":
                valid = (fy >= 0) & (fy <= h - 1) & (fx >= 0) & (fx <= w - 1)
                out = torch.where(valid[:, None], out, 0.0)
            return _ZeroGradTo.apply(out.to(a.dtype), g)
        y0 = torch.floor(fy).to(torch.int32)
        x0 = torch.floor(fx).to(torch.int32)
        y1, x1 = y0 + 1, x0 + 1
        wy, wx = fy - y0, fx - x0

        def corner(yi, xi):
            v = at(yi, xi)
            if padding_mode == "zeros":
                valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                v = torch.where(valid[:, None], v, 0.0)
            return v
        out = (corner(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
               + corner(y0, x1) * ((1 - wy) * wx)[:, None]
               + corner(y1, x0) * (wy * (1 - wx))[:, None]
               + corner(y1, x1) * (wy * wx)[:, None])
        return out.to(a.dtype)
    return apply("grid_sample", f, x, grid)
