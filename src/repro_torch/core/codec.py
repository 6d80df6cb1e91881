"""Wire codec for FGC updates: actual byte packing + exact decode.

The size *model* in core/compression.py is what the scheduler and all
claims use; this module makes the transport concrete: Golomb/Rice-coded
sparsity mask runs, fixed-width-packed level indices, sign bits, and the
(u_min, u_max, L) header — encode to ``bytes``, decode bit-exactly back to
the dequantized update vector.  Host-side numpy (the paper's device
uplink is host code): :func:`encode_update` takes tensors, on any
device, or arrays, and packs on the host.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def write(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def write_unary(self, q: int):
        self._bits.extend([1] * q)
        self._bits.append(0)

    def to_bytes(self) -> bytes:
        bits = self._bits + [0] * ((-len(self._bits)) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)

    def __len__(self):
        return len(self._bits)


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self._pos >> 3]
            bit = (byte >> (7 - (self._pos & 7))) & 1
            v = (v << 1) | bit
            self._pos += 1
        return v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 1:
            q += 1
        return q


def _rice_param(density: float) -> int:
    """Rice parameter k = log2 of the optimal Golomb m for gap coding."""
    density = min(max(density, 1e-9), 1 - 1e-9)
    m = max(-1.0 / math.log2(1.0 - density), 1.0)
    return max(int(round(math.log2(m))), 0)


@dataclasses.dataclass
class EncodedUpdate:
    payload: bytes
    n: int                      # vector length

    @property
    def bits(self) -> int:
        return len(self.payload) * 8


def encode_update(values: np.ndarray, levels: np.ndarray, mask: np.ndarray,
                  u_min: float, u_max: float, n_levels: int
                  ) -> EncodedUpdate:
    """Pack (levels, signs, mask) into bytes. values only supplies signs."""
    values, levels, mask = _host(values), _host(levels), _host(mask)
    n = int(values.size)
    nz = np.flatnonzero(mask)
    density = len(nz) / max(n, 1)
    k = _rice_param(density)
    lvl_bits = max(int(math.ceil(math.log2(n_levels + 1))), 1)
    w = BitWriter()
    # header: n(32) u_min/u_max(f32 as u32) L(16) k(8) nnz(32)
    w.write(n, 32)
    w.write(int(np.float32(u_min).view(np.uint32)), 32)
    w.write(int(np.float32(u_max).view(np.uint32)), 32)
    w.write(n_levels, 16)
    w.write(k, 8)
    w.write(len(nz), 32)
    # mask: Rice-coded gaps
    prev = -1
    for idx in nz:
        gap = int(idx - prev - 1)
        w.write_unary(gap >> k)
        if k:
            w.write(gap & ((1 << k) - 1), k)
        prev = int(idx)
    # levels + signs for the kept elements
    for idx in nz:
        w.write(int(levels[idx]), lvl_bits)
        w.write(1 if values[idx] < 0 else 0, 1)
    return EncodedUpdate(w.to_bytes(), n)


def decode_update(enc: EncodedUpdate) -> np.ndarray:
    """Exact inverse: dequantized f32 vector (zeros where dropped)."""
    r = BitReader(enc.payload)
    n = r.read(32)
    u_min = float(np.uint32(r.read(32)).view(np.float32))
    u_max = float(np.uint32(r.read(32)).view(np.float32))
    n_levels = r.read(16)
    k = r.read(8)
    nnz = r.read(32)
    lvl_bits = max(int(math.ceil(math.log2(n_levels + 1))), 1)
    idxs = np.zeros(nnz, np.int64)
    prev = -1
    for i in range(nnz):
        q = r.read_unary()
        rem = r.read(k) if k else 0
        gap = (q << k) | rem
        prev = prev + 1 + gap
        idxs[i] = prev
    out = np.zeros(n, np.float32)
    step = max(u_max - u_min, 1e-20) / max(n_levels, 1)
    for i in range(nnz):
        lvl = r.read(lvl_bits)
        sign = -1.0 if r.read(1) else 1.0
        out[idxs[i]] = sign * (u_min + lvl * step)
    return out
