"""The port's standalone cost and wire modules against the JAX package's:
``core/codec.py`` (Golomb/Rice byte packing of an FGC update) and
``sysmodel/energy.py`` (the Eq. 6-9 per-device costs and the Jetson
profiles).

The codec packs the same update in both packages: one compressed by the
port's FGC on a small pytree, handed over as tensors and as numpy
arrays; the bytes must be equal and the decode exact.  The cost
functions must return the reference's floats bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import codec as jcodec  # noqa: E402
from repro.sysmodel import energy as jenergy  # noqa: E402
from repro_torch.core import codec, compression  # noqa: E402
from repro_torch.sysmodel import energy  # noqa: E402
from repro_torch.utils.pytree import flatten_to_vector  # noqa: E402

torch.set_num_threads(1)


def _fgc_update(seed, beta):
    """(values, levels, mask, u_min, u_max, L) of one FGC-compressed
    update of a small pytree, as tensors."""
    gen = torch.Generator().manual_seed(seed)
    tree = {"conv": {"w": torch.randn(3, 3, 4, 16, generator=gen) * 1e-2,
                     "b": torch.randn(16, generator=gen) * 1e-2},
            "dense": {"w": torch.randn(64, 10, generator=gen) * 1e-2}}
    vec, _ = flatten_to_vector(tree)
    shapes = [(16,), (3, 3, 4, 16), (64, 10)]
    rand = torch.rand(vec.numel(), generator=gen)
    rho = compression.analytic_rho(beta)
    L = int(compression.analytic_levels(beta))
    norms = compression._norms(vec, shapes)
    fgc = compression._sparsify_quantize(vec, shapes, norms, rho, L, rand,
                                         compression.MAX_LEVELS)
    u_min, u_max = compression.masked_range(vec, fgc.mask)
    return fgc.values, fgc.levels, fgc.mask, float(u_min), float(u_max), L


@pytest.mark.parametrize("seed,beta", [(0, 0.003), (1, 0.02), (2, 0.0667),
                                       (3, 0.3)])
def test_codec_bytes_equal_the_reference_and_decode_exactly(seed, beta):
    values, levels, mask, u_min, u_max, L = _fgc_update(seed, beta)
    want = jcodec.encode_update(values.numpy(), levels.numpy(),
                                mask.numpy(), u_min, u_max, L)
    for args in ((values, levels, mask),
                 (values.numpy(), levels.numpy(), mask.numpy())):
        enc = codec.encode_update(*args, u_min, u_max, L)
        assert enc.payload == want.payload and enc.n == want.n
        assert enc.bits == want.bits
        got = codec.decode_update(enc)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jcodec.decode_update(want))
    # the decode rebuilds the dequantized update: the kept elements on the
    # (u_min, step) grid with their signs, zeros elsewhere
    step = max(u_max - u_min, 1e-20) / max(L, 1)
    kept = mask.numpy() > 0
    np.testing.assert_allclose(got[kept], values.numpy()[kept],
                               rtol=1e-5, atol=step * 1e-4)
    assert not got[~kept].any()


def test_codec_rice_parameter_and_bit_io_match():
    for density in (0.0, 1e-6, 0.01, 0.25, 0.5, 0.999, 1.0):
        assert codec._rice_param(density) == jcodec._rice_param(density)
    w, jw = codec.BitWriter(), jcodec.BitWriter()
    for v, n in ((5, 3), (0, 1), (1023, 10), (2 ** 31 + 7, 32)):
        w.write(v, n)
        jw.write(v, n)
    w.write_unary(6)
    jw.write_unary(6)
    assert w.to_bytes() == jw.to_bytes() and len(w) == len(jw)
    r = codec.BitReader(w.to_bytes())
    assert [r.read(3), r.read(1), r.read(10), r.read(32),
            r.read_unary()] == [5, 0, 1023, 2 ** 31 + 7, 6]


def test_energy_profiles_match():
    assert [dataclasses.asdict(p) for p in energy.PROFILES] == \
        [dataclasses.asdict(p) for p in jenergy.PROFILES]
    for name in ("JETSON_NANO", "JETSON_NX", "JETSON_XAVIER"):
        assert dataclasses.asdict(getattr(energy, name)) == \
            dataclasses.asdict(getattr(jenergy, name))


@pytest.mark.parametrize("profile", range(3))
def test_energy_cost_functions_match_exactly(profile):
    p, jp = energy.PROFILES[profile], jenergy.PROFILES[profile]
    rng = np.random.default_rng(profile)
    for _ in range(20):
        alpha, beta = float(rng.uniform(0.25, 1.0)), float(
            rng.uniform(1e-3, 1.0))
        freq = float(rng.uniform(p.f_min, p.f_max))
        kw = dict(W=float(rng.uniform(1e6, 1e9)), D=int(rng.integers(8, 512)),
                  tau=float(rng.choice([0.5, 1.0, 2.0])))
        S_bits, rate = float(rng.uniform(1e4, 1e8)), float(
            rng.uniform(1e5, 1e7))
        P = float(rng.uniform(0.1, 1.0))
        assert energy.compute_time(alpha, freq=freq, **kw) == \
            jenergy.compute_time(alpha, freq=freq, **kw)
        assert energy.compute_energy(alpha, freq=freq, eps_hw=p.eps_hw,
                                     **kw) == \
            jenergy.compute_energy(alpha, freq=freq, eps_hw=jp.eps_hw, **kw)
        assert energy.comm_time(alpha, beta, S_bits, rate) == \
            jenergy.comm_time(alpha, beta, S_bits, rate)
        assert energy.comm_energy(alpha, beta, S_bits, rate, P) == \
            jenergy.comm_energy(alpha, beta, S_bits, rate, P)
        both = dict(kw, eps_hw=p.eps_hw, S_bits=S_bits, rate=rate,
                    tx_power_w=P)
        assert energy.round_cost(alpha, beta, freq, **both) == \
            jenergy.round_cost(alpha, beta, freq, **both)
