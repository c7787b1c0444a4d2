"""The Mamba-2 mixer's scan over a packed step: port-only, no JAX twin.

The JAX package serves no SSM on its paged engine and has no Pallas
kernel for this; the port's interleaved family (granite-4.0-h-micro)
serves Mamba-2 layers through the packed PagedEngine, and this is the scan
each of those layers makes once a step:

    ssd_packed_scan(zxbcdt, conv_w, conv_b, conv_state, ssm_state, A_log,
                    dt_bias, D, segments, slot_ids, ...) -> y (W, d_inner)

zxbcdt (W, 2 di + 2gn + nh) is the in-projection of the step's W packed
lanes, [z | x B C | dt]. Each slot's segment (`segments`: first lane,
tokens, position of its first token; models/ssm.py packed_segments) runs
the depthwise causal conv over its raw x B C lanes, continued from the
slot's last K-1 raw inputs (`conv_state` (S, K-1, C)), and the SSD
recurrence from the slot's state (`ssm_state` (S, nh, n, hp) float32),
both read as zeros where the segment starts at position 0: a reused slot
never sees its last request's state, and admission costs no launch. The
final state and window are written back in place. Pad lanes (slot -1)
read and write no slot's state and get y = 0. y is x's SSD output with
the D skip, in zxbcdt's dtype, before the gate.

CUDA tensors launch the hand-written kernel (csrc/ssd_packed.cu: two
kernels, scan then window, in one C call, whatever the number of slots or
segments) and bump `ssd_packed_scan.launches`; CPU tensors run the plain
PyTorch version `ssd_packed_scan_ref`, a loop over the segments through
the chunked SSD of models/ssm.py. There is no fallback from one to the
other. The kernel runs the recurrence token by token in float32; the
plain version the chunked form: the same sums in another order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import cuda_device, launch

# element codes shared with csrc/ssd_packed.cu
ELEM_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widths the kernel's thread layout holds: a head's (n, hp) state over
# 256 threads, 16 rows of n by 2 columns of hp each, and 4 conv taps
# (csrc/ssd_packed.cu)
KERNEL_STATE, KERNEL_HEAD_DIM, KERNEL_CONV = 128, 64, 4


def ssd_packed_scan_ref(zxbcdt, conv_w, conv_b, conv_state, ssm_state,
                        A_log, dt_bias, D, segments, slot_ids, *, d_inner,
                        state, head_dim, groups, chunk):
    """Plain PyTorch version of ssd_packed_scan (same arguments and
    in-place writes): each segment's conv in float32, its SSD through the
    chunked form (models/ssm.py _ssd_chunks) from the slot's state."""
    from repro_torch.models.ssm import _ssd_chunks, softplus

    w_lanes = zxbcdt.shape[0]
    nh, gn = d_inner // head_dim, groups * state
    c = d_inner + 2 * gn
    k = conv_w.shape[1]
    out = torch.zeros((w_lanes, d_inner), dtype=zxbcdt.dtype,
                      device=zxbcdt.device)
    start, length, pos0 = (s.tolist() for s in segments)
    for slot, tv in enumerate(length):
        if not tv:
            continue
        s0, fresh = start[slot], pos0[slot] == 0
        seg = zxbcdt[s0:s0 + tv].float()
        win = (torch.zeros((k - 1, c), device=zxbcdt.device) if fresh
               else conv_state[slot].float())
        ext = torch.cat([win, seg[:, d_inner:d_inner + c]])
        acc = conv_b.float().expand(tv, c)
        for j in range(k):
            acc = acc + conv_w[:, j].float() * ext[j:j + tv]
        xbc = F.silu(acc)
        x = xbc[:, :d_inner].reshape(1, tv, nh, head_dim)
        b_in = xbc[:, d_inner:d_inner + gn].reshape(1, tv, groups, state)
        c_out = xbc[:, d_inner + gn:].reshape(1, tv, groups, state)
        dt = softplus(seg[:, d_inner + c:] + dt_bias)[None]
        a = -torch.exp(A_log) * dt
        y, h = _ssd_chunks(x, b_in, c_out, dt, a, min(chunk, tv),
                           None if fresh else ssm_state[slot][None])
        y = y + D[None, None, :, None] * x
        out[s0:s0 + tv] = y.reshape(tv, d_inner).to(out.dtype)
        ssm_state[slot] = h[0]
        conv_state[slot] = ext[tv:].to(conv_state.dtype)
    return out


def ssd_packed_scan(zxbcdt, conv_w, conv_b, conv_state, ssm_state, A_log,
                    dt_bias, D, segments, slot_ids, *, d_inner, state,
                    head_dim, groups, chunk):
    """The packed step's conv and SSD, from and back to per-slot state
    (module docstring). CUDA: one C call, two launches; the kernel takes
    groups 1, state 128, head_dim 64 (granite-4.0-h-micro's and
    mamba2-1.3b's), conv width 4, float32 or bfloat16 activations and
    conv, and raises on anything else."""
    if zxbcdt.device.type == "cpu":
        return ssd_packed_scan_ref(
            zxbcdt, conv_w, conv_b, conv_state, ssm_state, A_log, dt_bias,
            D, segments, slot_ids, d_inner=d_inner, state=state,
            head_dim=head_dim, groups=groups, chunk=chunk)
    k = conv_w.shape[1]
    if (groups, state, head_dim, k) != (1, KERNEL_STATE, KERNEL_HEAD_DIM,
                                        KERNEL_CONV):
        raise ValueError(f"ssd_packed_scan's kernel takes groups 1, state "
                         f"{KERNEL_STATE}, head_dim {KERNEL_HEAD_DIM}, conv "
                         f"width {KERNEL_CONV}; got {groups}, {state}, "
                         f"{head_dim}, {k}")
    nh, c = d_inner // head_dim, d_inner + 2 * state
    w_lanes, width = zxbcdt.shape
    slots = ssm_state.shape[0]
    elem = ELEM_TYPES.get(zxbcdt.dtype)
    if elem is None or {conv_w.dtype, conv_b.dtype,
                        conv_state.dtype} != {zxbcdt.dtype}:
        raise ValueError(f"zxbcdt and the conv must share float32 or "
                         f"bfloat16, got {zxbcdt.dtype}, {conv_w.dtype}, "
                         f"{conv_b.dtype}, {conv_state.dtype}")
    if len(segments) != 3:
        raise ValueError("segments are packed_segments' three arrays")
    if width != d_inner + c + nh:
        raise ValueError(f"zxbcdt rows hold {width}, not z x B C dt = "
                         f"{d_inner + c + nh}")
    shapes = {"conv_w": (conv_w, (c, k)), "conv_b": (conv_b, (c,)),
              "conv_state": (conv_state, (slots, k - 1, c)),
              "ssm_state": (ssm_state, (slots, nh, state, head_dim)),
              "A_log": (A_log, (nh,)), "dt_bias": (dt_bias, (nh,)),
              "D": (D, (nh,)), "slot_ids": (slot_ids, (w_lanes,))}
    shapes.update({name: (t, (slots,)) for name, t in
                   zip(("seg_start", "seg_len", "seg_pos0"), segments)})
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, not {want}")
    if any(t.dtype != torch.float32 for t in (ssm_state, A_log, dt_bias, D)):
        raise ValueError("ssm_state, A_log, dt_bias and D must be float32")
    if any(t.dtype != torch.int32 for t in (slot_ids, *segments)):
        raise ValueError("slot_ids and the segments must be int32")
    dev = cuda_device(zxbcdt, conv_w, conv_b, conv_state, ssm_state, A_log,
                      dt_bias, D, slot_ids, *segments)
    out = torch.empty((w_lanes, d_inner), dtype=zxbcdt.dtype, device=dev)
    if w_lanes:
        launch(ssd_packed_scan, "ssd_packed_launch", dev, zxbcdt, conv_w,
               conv_b, conv_state, ssm_state, A_log, dt_bias, D, *segments,
               slot_ids, out, w_lanes, slots, nh, d_inner, elem)
    return out


# launches of the CUDA kernel in this process (CPU calls never count)
ssd_packed_scan.launches = 0
