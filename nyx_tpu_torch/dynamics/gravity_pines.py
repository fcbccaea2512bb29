"""The Pines gravity recursion: packed tables, the CUDA kernel, its torch twin.

Port of nyx_tpu/dynamics/gravity_pallas.py. `pack_tables` lays the
per-degree recursion rows out as one `[n_steps, 8, W_pad]` array, shared by
the two implementations:

- `pines_accel_cuda`: the hand-written Hopper kernel (`csrc/pines.cu`), f32,
  on CUDA tensors only, for a field of any degree; `pines_launch_plan` sizes
  its blocks and its shared memory;
- `pines_accel_torch`: the plain PyTorch twin, at the dtype of its input. It
  is the only path for CPU tensors and the reference the kernel is checked
  against on the card;
- `pines_tangent_torch`: the twin's forward-mode tangent, which serves the
  kernel's derivatives (the reference has no tangent Pallas kernel).

`pines_accel` picks between the first two by the device of the input alone.
The call counters (`pines_accel_cuda.launches`, the twins' `cuda_calls`)
are added to under `COUNT_LOCK`, so the shards of a mesh, one host thread
each, lose no count.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import _cuda

# Guards the read-modify-write of every call counter of this module.
COUNT_LOCK = threading.Lock()
_SQRT2 = np.sqrt(2.0)
_SQRT3 = float(np.sqrt(3.0))
# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_PER_BLOCK = 232_448
# Warps a block, one lane each: 1024 threads, the most a block holds, so an
# SM runs 32 warps at the kernel's 64 registers a thread.
_WARPS = 32
# Shared memory a streamed block takes: two buffers of ~47 degree steps, one
# barrier pair a chunk. Not tuned: any size from one step up is correct.
_STREAM_BYTES = SMEM_PER_BLOCK // 2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_tables(xs, N: int, W: int, q_hi: int = 0, dtype=np.float32) -> np.ndarray:
    """Host-side packing of the per-degree recursion rows into one
    `[n_steps, 8, W_pad]` array, n_steps = min(N, q_hi or N).

    Row order: b_row*mask, c_row*mask, diag_vec, offdiag_vec, C*sqrt2,
    S*sqrt2, vr01, vr11. The one-hot diagonal seeds of the recursion are
    pre-baked into dense rows so both implementations are pure elementwise
    work. At float32 the array is bitwise the Pallas kernel's table.
    """
    q_hi = q_hi or N
    n_steps = min(N, q_hi)
    W_pad = _round_up(W, 8)
    tab = np.zeros((n_steps, 8, W_pad), dtype)
    for k in range(n_steps):
        n = int(xs["n_is"][k])
        mask = xs["row_mask"][k]
        tab[k, 0, :W] = xs["b_row"][k] * mask
        tab[k, 1, :W] = xs["c_row"][k] * mask
        if n < W:
            tab[k, 2, n] = xs["diag_n"][k]
        if n - 1 < W:
            tab[k, 3, n - 1] = xs["offdiag_n"][k]
        tab[k, 4, :W] = xs["C_q"][k] * _SQRT2
        tab[k, 5, :W] = xs["S_q"][k] * _SQRT2
        tab[k, 6, :W] = xs["vr01_q"][k]
        tab[k, 7, :W] = xs["vr11_q"][k]
    return tab


def pines_accel_torch(r_bf, tab, q_lo: int, *, W: int, mu: float, radius: float,
                      diag1: float):
    """Plain PyTorch Pines recursion from the packed table.

    `r_bf` [B, 3] body-fixed km, `tab` [n_steps, 8, W_pad] at the dtype of
    `r_bf`; degrees q in (q_lo, n_steps] accumulate. Returns [B, 3] km/s^2.
    Each operation is the Pallas kernel's, over the full padded width.
    """
    if r_bf.is_cuda:
        with COUNT_LOCK:
            pines_accel_torch.cuda_calls += 1
    return _pines_twin(r_bf, tab, q_lo, W, mu, radius, diag1)


def pines_tangent_torch(r_bf, dr_bf, tab, q_lo: int, *, W: int, mu: float, radius: float,
                        diag1: float):
    """Forward-mode tangent [B, 3] of the twin at `r_bf` along `dr_bf`, over
    the same degree window: the plain recursion carried with its tangent by
    hand, each operation's derivative the one `torch.func.jvp` takes, in the
    same order, so the two agree bit for bit at a tenth of the host's cost
    (functorch adds tens of microseconds an operation). The kernel's primal
    pairs with it in `gravity.PinesAccel`."""
    if r_bf.is_cuda:
        with COUNT_LOCK:
            pines_tangent_torch.cuda_calls += 1
    return _pines_twin_tangent(r_bf, dr_bf, tab, q_lo, W, mu, radius, diag1)


def _pines_twin(r_bf, tab, q_lo, W, mu, radius, diag1):
    """The plain recursion. Only the Legendre rows, the radius powers and
    the sums run degree by degree; each degree's four terms are computed
    for every degree at once, each element by the kernel's operations in
    the kernel's order, so the bits are the kernel's."""
    dt, dev = r_bf.dtype, r_bf.device
    n_steps, _, W_pad = tab.shape
    x, y, z = r_bf[:, 0], r_bf[:, 1], r_bf[:, 2]
    r = torch.sqrt(x * x + y * y + z * z)
    inv_r = 1.0 / r
    s_, t_, u_ = x * inv_r, y * inv_r, z * inv_r
    rho = (radius * inv_r)[:, None]
    mu_over_r = (mu * inv_r)[:, None]
    u = u_[:, None]

    # r_m / i_m: powers of (s + i t), columns m = 0..W-1, zero-padded
    rms, ims = [torch.ones_like(x)], [torch.zeros_like(x)]
    for _ in range(1, W):
        rm, im = rms[-1], ims[-1]
        rms.append(s_ * rm - t_ * im)
        ims.append(s_ * im + t_ * rm)
    pad = [torch.zeros_like(x)] * (W_pad - W)
    ri = torch.stack([torch.stack(rms + pad, dim=1), torch.stack(ims + pad, dim=1)])  # [2, B, W_pad]
    ri1 = torch.cat([torch.zeros_like(ri[..., :1]), ri[..., :-1]], dim=-1)

    m_f = torch.arange(W_pad, dtype=dt, device=dev)
    onehot0 = (m_f == 0).to(dt)
    onehot1 = (m_f == 1).to(dt)
    row_nm2 = onehot0.expand(r_bf.shape[0], W_pad)
    row_nm1 = (u * _SQRT3) * onehot0 + diag1 * onehot1
    rho_q = mu_over_r * rho
    acc = torch.zeros((4,) + row_nm1.shape, dtype=dt, device=dev)  # x, y, z, w
    sign = _sign(dt, dev)
    kept = []
    for k in range(n_steps):
        b_row, c_row, diag_v, offd_v = tab[k, 0], tab[k, 1], tab[k, 2], tab[k, 3]
        row_n = u * b_row * row_nm1 - c_row * row_nm2 + diag_v + offd_v * u
        rho_q = rho_q * rho
        if k + 1 > q_lo:
            kept.append((row_nm1, row_n, rho_q))
        row_nm1, row_nm2 = row_n, row_nm1
        if kept and (len(kept) == _CHUNK or k == n_steps - 1):
            # the chunk's degrees k0..k, their terms at once, summed in order
            rn1, rn, rq = (torch.stack(a) for a in zip(*kept))
            tk = tab[k + 1 - len(kept):k + 1]
            g, _ = _terms_g(tk, ri, ri1, None, None)
            p = sign * ((_terms_c(rq * (1.0 / radius), tk, m_f) * _terms_row(rn1, rn)) * g)
            for i in range(len(kept)):
                acc = acc + p[i]
            kept = []
    ax, ay, az, aw = _sum_orders(acc).unbind(0)
    return torch.stack([ax + aw * s_, ay + aw * t_, az + aw * u_], dim=1)


def _sign(dt, dev):
    """[4, 1, 1]: the sign each term adds with, acc_w's subtracting (a - b is
    a + (-b) exactly, and (-1) * b is -b). Made on the device, no copy from
    the host."""
    return (1.0 - 2.0 * (torch.arange(4, device=dev) == 3).to(dt))[:, None, None]


def _terms_g(tk, ri, ri1, d_ri, d_ri1):
    """e_, f_, d_, d_ of degrees `tk` [K, 8, W] (and their tangents along
    d_ri, when given): [K, 4, B, W]. d_ = C r_m + S i_m, e_ = C r_m-1 +
    S i_m-1, f_ = S r_m-1 - C i_m-1 (as S r_m-1 + (-C) i_m-1, the same
    bits)."""
    c_q, s_q = tk[:, 4, None, :], tk[:, 5, None, :]
    cs = torch.stack([c_q, s_q, c_q, c_q], dim=1)  # [K, 4, 1, W]
    sc = torch.stack([s_q, -c_q, s_q, s_q], dim=1)

    def combine(a, a1):
        return cs * torch.stack([a1[0], a1[0], a[0], a[0]]) + sc * torch.stack([a1[1], a1[1], a[1], a[1]])

    return combine(ri, ri1), None if d_ri is None else combine(d_ri, d_ri1)


def _terms_c(rr, tk, m_f):
    """The four terms' factors rr*m, rr*m, rr*vr01, rr*vr11: [K, 4, B, W]
    from rr [K, B, 1]."""
    m_row = m_f.expand_as(tk[:, 6])
    return rr[:, None] * torch.stack([m_row, m_row, tk[:, 6], tk[:, 7]], dim=1)[:, :, None, :]


def _terms_row(rn1, rn):
    """The four terms' rows: row_nm1, row_nm1, row_nm1 and row_n shifted one
    order down: [K, 4, B, W]."""
    zcol = torch.zeros_like(rn1[..., :1])
    return torch.stack([rn1, rn1, torch.cat([rn1[..., 1:], zcol], -1), torch.cat([rn[..., 1:], zcol], -1)], 1)


def _pines_twin_tangent(r_bf, dr_bf, tab, q_lo, W, mu, radius, diag1):
    """The tangent of `_pines_twin` along `dr_bf`. Each value pairs a primal
    operation with its forward derivative as autograd defines it: a product
    a*b takes da*b + a*db, sqrt(q) dq / (2 sqrt(q)), 1/r -dr (1/r)^2, a sum
    the sum of the tangents; a constant's tangent is zero and its terms are
    dropped (autograd's zero tangents add nothing). Only the Legendre rows,
    the radius powers and the sums run degree by degree; each degree's
    terms are computed for every degree at once (each element by the same
    operations, so the same bits), in chunks of _CHUNK degrees."""
    dt, dev = r_bf.dtype, r_bf.device
    n_steps, _, W_pad = tab.shape
    x, y, z = r_bf[:, 0], r_bf[:, 1], r_bf[:, 2]
    dx, dy, dz = dr_bf[:, 0], dr_bf[:, 1], dr_bf[:, 2]
    r = torch.sqrt(x * x + y * y + z * z)
    d_r = ((dx * x + dx * x) + (dy * y + dy * y) + (dz * z + dz * z)) / (r * 2)
    rec = torch.reciprocal(r)
    inv_r = rec * 1.0
    d_inv = ((-d_r) * (rec * rec)) * 1.0
    s_, t_, u_ = x * inv_r, y * inv_r, z * inv_r
    ds, dt_, du_ = d_inv * x + dx * inv_r, d_inv * y + dy * inv_r, d_inv * z + dz * inv_r
    rho = (radius * inv_r)[:, None]
    d_rho = (d_inv * radius)[:, None]
    mu_over_r = (mu * inv_r)[:, None]
    d_mor = (d_inv * mu)[:, None]
    u = u_[:, None]
    du = du_[:, None]

    zero = torch.zeros_like(x)
    rms, ims, drms, dims = [torch.ones_like(x)], [zero], [zero], [zero]
    for _ in range(1, W):
        rm, im, drm, dim = rms[-1], ims[-1], drms[-1], dims[-1]
        rms.append(s_ * rm - t_ * im)
        ims.append(s_ * im + t_ * rm)
        drms.append((drm * s_ + ds * rm) - (dim * t_ + dt_ * im))
        dims.append((dim * s_ + ds * im) + (drm * t_ + dt_ * rm))
    pad = [zero] * (W_pad - W)
    # [2, B, W_pad]: the powers r_m, i_m and the same shifted one order up
    ri = torch.stack([torch.stack(rms + pad, dim=1), torch.stack(ims + pad, dim=1)])
    d_ri = torch.stack([torch.stack(drms + pad, dim=1), torch.stack(dims + pad, dim=1)])
    zcol = torch.zeros_like(ri[..., :1])
    ri1 = torch.cat([zcol, ri[..., :-1]], dim=-1)
    d_ri1 = torch.cat([zcol, d_ri[..., :-1]], dim=-1)

    # the Legendre rows and radius powers, degree by degree (sequential)
    m_f = torch.arange(W_pad, dtype=dt, device=dev)
    onehot0 = (m_f == 0).to(dt)
    onehot1 = (m_f == 1).to(dt)
    row_nm2 = onehot0.expand(r_bf.shape[0], W_pad)
    d_row_nm2 = torch.zeros_like(row_nm2)
    row_nm1 = (u * _SQRT3) * onehot0 + diag1 * onehot1
    d_row_nm1 = (du * _SQRT3) * onehot0
    rho_q = mu_over_r * rho
    d_rho_q = d_rho * mu_over_r + d_mor * rho
    d_acc = torch.zeros((4,) + row_nm1.shape, dtype=dt, device=dev)
    acc_w = torch.zeros_like(row_nm1)  # the primal's, for the products with s, t, u
    sign = _sign(dt, dev)
    kept = []
    for k in range(n_steps):
        b_row, c_row, diag_v, offd_v = tab[k, 0], tab[k, 1], tab[k, 2], tab[k, 3]
        ub = u * b_row
        row_n = ub * row_nm1 - c_row * row_nm2 + diag_v + offd_v * u
        d_row_n = (d_row_nm1 * ub + (du * b_row) * row_nm1) - c_row * d_row_nm2 + offd_v * du
        d_rho_q = d_rho * rho_q + d_rho_q * rho
        rho_q = rho_q * rho
        if k + 1 > q_lo:
            kept.append((row_nm1, d_row_nm1, row_n, d_row_n, rho_q, d_rho_q))
        row_nm1, row_nm2, d_row_nm1, d_row_nm2 = row_n, row_nm1, d_row_n, d_row_nm1
        if kept and (len(kept) == _CHUNK or k == n_steps - 1):
            # the chunk's degrees at once, summed in order
            rn1, drn1, rn, drn, rq, drq = (torch.stack(a) for a in zip(*kept))  # [K, B, W] / [K, B, 1]
            tk = tab[k + 1 - len(kept):k + 1]
            g, dg = _terms_g(tk, ri, ri1, d_ri, d_ri1)
            c, dc = _terms_c(rq * (1.0 / radius), tk, m_f), _terms_c(drq * (1.0 / radius), tk, m_f)
            row, drow = _terms_row(rn1, rn), _terms_row(drn1, drn)
            p1 = c * row
            dp2 = sign * (dg * p1 + (drow * c + dc * row) * g)
            pw = p1[:, 3] * g[:, 3]
            for i in range(len(kept)):
                d_acc = d_acc + dp2[i]
                acc_w = acc_w - pw[i]
            kept = []

    aw = _sum_orders(acc_w)
    dax, day, daz, daw = _sum_orders(d_acc).unbind(0)
    return torch.stack([dax + (ds * aw + daw * s_), day + (dt_ * aw + daw * t_),
                        daz + (du_ * aw + daw * u_)], dim=1)


def _sum_orders(acc):
    """Sum over the order axis (the last) from m = 0 up, the kernel's order:
    with every other operation also the kernel's, the twin and the kernel
    give the same f32 bits, so a run through either takes the same steps."""
    out = acc[..., 0]
    for m in range(1, acc.shape[-1]):
        out = out + acc[..., m]
    return out


# Degrees whose terms one pass computes at once (bounds the [degrees, 4, B,
# W] temporaries at high degree and wide batches).
_CHUNK = 16

pines_accel_torch.cuda_calls = 0  # primal calls made on CUDA tensors
pines_tangent_torch.cuda_calls = 0  # tangent calls made on CUDA tensors


@dataclass(frozen=True)
class PinesPlan:
    """How `csrc/pines.cu` runs a table of `n_steps` degree steps: `warps` a
    block, `buffers` of `chunk_steps` degree steps and `cols` columns in
    shared memory (one holding the whole table, or two that stream it one
    group of 32 columns at a time), `smem_bytes` of dynamic shared memory."""

    n_steps: int
    warps: int
    buffers: int
    chunk_steps: int
    cols: int
    smem_bytes: int

    @property
    def whole(self) -> bool:
        return self.buffers == 1

    def chunks(self) -> list[tuple[int, int]]:
        """The degree steps [k0, k1) of each buffer load, as the kernel cuts them."""
        c = self.chunk_steps
        return [(k0, min(self.n_steps, k0 + c)) for k0 in range(0, self.n_steps, c)]


@functools.cache
def pines_launch_plan(n_steps: int, W_pad: int) -> PinesPlan:
    """The kernel's block and shared-memory plan for a [n_steps, 8, W_pad]
    table.

    A buffer holds each staged column's 8 values of a degree step as two
    float4 (32 bytes). The whole table (W_pad columns and a zero one) is
    staged once per block when it fits beside the per-warp reduction
    scratch (4 sums x 33 floats); otherwise two buffers of degree steps
    stream one group of columns at a time (its 32 and the next group's
    first), so the footprint does not grow with the degree."""
    if n_steps < 1 or W_pad < 8 or W_pad % 8:
        raise ValueError(f"no plan for a table of {n_steps} steps x {W_pad} columns")
    scratch = 16 * _WARPS * 33
    whole = 32 * n_steps * (W_pad + 1) + scratch
    if whole <= SMEM_PER_BLOCK:
        return PinesPlan(n_steps, _WARPS, 1, n_steps, W_pad + 1, whole)
    cols = 33
    chunk = max(1, min(n_steps, (_STREAM_BYTES - scratch) // (64 * cols)))
    return PinesPlan(n_steps, _WARPS, 2, chunk, cols, 64 * chunk * cols + scratch)


@functools.cache
def _bind():
    built = _cuda.load("pines")
    fn = built.lib.pines_accel_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 4
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def pines_accel_cuda(r_bf, tab, q_lo: int, *, W: int, mu: float, radius: float,
                     diag1: float):
    """The Pines recursion on the card (`csrc/pines.cu`), f32, any degree.

    Same contract as `pines_accel_torch`; `pines_launch_plan` sizes the
    launch. Raises on anything the kernel does not take: a tensor off CUDA,
    a dtype other than float32, a non-contiguous or misshapen input, or a
    launch the device refuses.
    """
    if not (r_bf.is_cuda and tab.is_cuda) or r_bf.device != tab.device:
        raise ValueError("pines_accel_cuda takes CUDA tensors on one device")
    if r_bf.dtype != torch.float32 or tab.dtype != torch.float32:
        raise TypeError(f"pines_accel_cuda takes float32, got {r_bf.dtype} and {tab.dtype}")
    if r_bf.dim() != 2 or r_bf.shape[1] != 3:
        raise ValueError(f"r_bf must be [B, 3], got {tuple(r_bf.shape)}")
    if tab.dim() != 3 or tab.shape[1] != 8 or not 2 <= W <= tab.shape[2] or tab.shape[2] % 8:
        raise ValueError(
            f"tab must be [n_steps, 8, W_pad >= W={W}, a multiple of 8], got {tuple(tab.shape)}"
        )
    if not (r_bf.is_contiguous() and tab.is_contiguous()):
        raise ValueError("pines_accel_cuda takes contiguous tensors")
    n_steps, _, W_pad = tab.shape
    plan = pines_launch_plan(n_steps, W_pad)
    out = torch.empty_like(r_bf)
    B = r_bf.shape[0]
    if B == 0:
        return out
    fn = _bind()
    with torch.cuda.device(r_bf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            r_bf.data_ptr(), tab.data_ptr(), out.data_ptr(),
            B, n_steps, W, W_pad, int(q_lo),
            float(np.float32(mu)), float(np.float32(radius)),
            float(np.float32(1.0 / radius)), float(np.float32(diag1)),
            plan.warps, plan.buffers, plan.chunk_steps, plan.cols, plan.smem_bytes,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"pines kernel launch failed with CUDA error {err}")
    with COUNT_LOCK:
        pines_accel_cuda.launches += 1
    return out


pines_accel_cuda.launches = 0  # successful kernel launches


def pines_accel(r_bf, tab, q_lo: int, *, W: int, mu: float, radius: float,
                diag1: float):
    """The kernel for a CUDA tensor, the twin for a CPU tensor."""
    fn = pines_accel_cuda if r_bf.is_cuda else pines_accel_torch
    return fn(r_bf, tab, q_lo, W=W, mu=mu, radius=radius, diag1=diag1)
