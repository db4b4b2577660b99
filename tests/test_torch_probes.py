"""The card probes P1-P4 of the PyTorch port against the TPU package's
probe scripts, on the CPU.

The probes' kernel bodies (`scripts/probe_*.py`) run as the JAX package's
tests run kernels: a local `pl.pallas_call(..., interpret=
pltpu.InterpretParams())` with each script's own in/out/scratch specs,
its module constants cut by `monkeypatch.setattr` (N stays >= 4096 for
P3b, whose body multiplies the first 4096 columns). The port's plain
versions (what the kernels compute on the card, `csrc/stream_probes.cu`)
are held against them:

- P2: the chain's value, int8 and int4 (plane-split nibbles), fp32 to
  1e-5 relative; `unpack_int4_nibbles` bit-equal on all 256 byte values.
- P3a: `pack_rows` / `unpack_rows` against `semantics`' bitcast kernel on
  its labelled rows, bit for bit.
- P3b: the value against `_chain_kernel` in both modes (fp32 to 1e-5
  relative), the two modes equal. The script's body assigns a value made
  inside `pl.when` to a list outside it, which escapes the branch's trace
  (jax 0.9 refuses it as captured constants, ROADMAP R10): the test runs
  the body with `pl.when` replaced, for such branches only, by computing
  the branch and selecting its values by the predicate, the value the
  script means.
- P4: the value against `_kernel` under TOKENPACKER_FD_DEBUG=nodot, for
  every dtype: exactly (1e-6 relative, the fp32 rounding of the TPU sum)
  for the integer types; bf16 within the bf16 rounding of each chunk's
  sum, which the TPU kernel keeps in bf16.
- P1 and P4: the checksums against numpy; P1's bytes a call equal to the
  script's reps * CK * NCOLS.

`probe_stream_dtype.py` sets TOKENPACKER_FD_DEBUG at import; it is
imported only under `monkeypatch.setenv`, so that the variable goes with
the test and does not reach the JAX fused-decode tests that share the
worker (they read it at trace time).
"""

import functools
import importlib
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scripts import probe_bitcast_pack as jax_p3
from scripts import probe_dma_stride as jax_p1
from scripts import probe_int4_ring as jax_p2
from tokenpacker_tpu_torch.probes import bitcast_pack, dma_stride, int4_ring, stream_dtype

REL = 1e-5  # fp32 GEMV sums against float64, sums in another order


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def test_constants_are_the_scripts():
    assert (dma_stride.CK, dma_stride.NCOLS, dma_stride.NROWS) == (
        jax_p1.CK, jax_p1.NCOLS, jax_p1.NROWS)
    assert (int4_ring.L, int4_ring.N, int4_ring.K, int4_ring.CK, int4_ring.NSLOTS,
            int4_ring.B) == (jax_p2.L, jax_p2.N, jax_p2.K, jax_p2.CK, jax_p2.NSLOTS, jax_p2.B)
    assert (bitcast_pack.CK, bitcast_pack.N, bitcast_pack.K, bitcast_pack.B, bitcast_pack.L,
            bitcast_pack.NSLOTS) == (jax_p3.CK, jax_p3.N, jax_p3.K, jax_p3.B, jax_p3.L,
                                     jax_p3.NSLOTS)
    assert (stream_dtype.L, stream_dtype.N, stream_dtype.K_BYTES, stream_dtype.CK_BYTES,
            stream_dtype.B, stream_dtype.NSLOTS) == (8, 12288, 4096, 512, 8, 2)


# -- P2 ---------------------------------------------------------------------------------


def test_unpack_int4_nibbles_bit_equal_on_every_byte():
    p = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    want = np.asarray(jax_p2.unpack_int4_nibbles(jnp.asarray(p)))
    got = int4_ring.unpack_int4_nibbles(torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("reps", [3, 4])
def test_int4_ring_chain_matches_the_kernel_body(monkeypatch, mode, reps):
    """`chain_plain` against `_kernel` of the script at L 2, N 256, K 1024,
    CK 512, B 2 (reps 3 streams layer 0 twice and layer 1 once)."""
    for name, value in dict(L=2, N=256, K=1024, CK=512, B=2).items():
        monkeypatch.setattr(jax_p2, name, value)
    rng = np.random.default_rng(0)
    rows = 1024 if mode == "int8" else 512
    w = rng.integers(-127, 127, (2, rows, 256), dtype=np.int8)
    x = (rng.standard_normal((2, 1024)) * 0.1).astype(jnp.bfloat16)
    unpack = jax_p2.unpack_int4_nibbles if mode == "int4" else None
    want = pl.pallas_call(
        functools.partial(jax_p2._kernel, reps=reps, unpack=unpack),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((2, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, 512 if mode == "int8" else 256, 256), jnp.int8),
                        pltpu.VMEM((2, 2, 512), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = int4_ring.chain(xt, torch.from_numpy(w), reps, mode)
    assert got.shape == (2, 1) and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) <= REL
    # the chain without its last 512-row chunk (or the planes swapped) is another value
    lossy = int4_ring.chain_plain(xt[:, :512], torch.from_numpy(w[:, :rows // 2]), reps, mode)
    assert _rel(lossy.numpy(), np.asarray(want)) > 1e-2


def test_int4_planes_are_plane_split_per_chunk():
    """Source rows [c*256, (c+1)*256) give W rows c*512 + [0, 256) (high
    nibbles) and c*512 + [256, 512) (low nibbles)."""
    w4 = torch.from_numpy(np.random.default_rng(1).integers(-128, 128, (1, 512, 8),
                                                            dtype=np.int8))
    w = int4_ring.unpack_planes(w4)
    p = w4[0].to(torch.int32)
    for c in range(2):
        src = p[c * 256:(c + 1) * 256]
        assert torch.equal(w[0, c * 512:c * 512 + 256], src >> 4)
        assert torch.equal(w[0, c * 512 + 256:(c + 1) * 512], ((src & 15) ^ 8) - 8)


# -- P3 ---------------------------------------------------------------------------------


def test_pack_rows_matches_the_bitcast_kernel():
    """P3a: the labelled rows of `semantics` through `pltpu.bitcast` (int8
    [64, 256] -> bf16 [32, 256] -> int8) against `pack_rows` and
    `unpack_rows`, bit for bit: row r holds int8 row 2r low, 2r + 1 high."""

    def kern(src_ref, rt_ref, bf_ref):
        as_bf16 = pltpu.bitcast(src_ref[...], jnp.bfloat16)
        rt_ref[...] = pltpu.bitcast(as_bf16, jnp.int8)
        bf_ref[...] = as_bf16

    src = np.broadcast_to(np.arange(64, dtype=np.int8)[:, None], (64, 256)).copy()
    rt, bf = pl.pallas_call(
        kern,
        out_shape=[jax.ShapeDtypeStruct((64, 256), jnp.int8),
                   jax.ShapeDtypeStruct((32, 256), jnp.bfloat16)],
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(src))
    packed = bitcast_pack.pack_rows(torch.from_numpy(src))
    assert packed.dtype == torch.int16 and packed.shape == (32, 256)
    np.testing.assert_array_equal(packed.numpy().view(np.uint16), np.asarray(bf).view(np.uint16))
    np.testing.assert_array_equal(bitcast_pack.unpack_rows(packed).numpy(), np.asarray(rt))
    np.testing.assert_array_equal(np.asarray(rt), src)
    # every byte value survives the round trip, and column pairing is not this packing
    w8 = torch.from_numpy(np.random.default_rng(2).integers(-128, 128, (2, 8, 12), dtype=np.int8))
    assert torch.equal(bitcast_pack.unpack_rows(bitcast_pack.pack_rows(w8)), w8)
    assert not torch.equal(bitcast_pack.pack_rows(w8)[0], w8[0].view(torch.int16)[:4])


@pytest.fixture
def p3_when_select(monkeypatch):
    """`pl.when` for the P3b body: a branch that writes into a list of its
    closure runs unconditionally and its list entries are selected by the
    predicate; every other branch (the DMA starts) stays a `pl.when`."""
    real_when = pl.when

    def when(pred):
        def deco(f):
            lists = [c.cell_contents for c in (f.__closure__ or ())
                     if isinstance(c.cell_contents, list)]
            if not lists:
                return real_when(pred)(f)
            before = [list(x) for x in lists]
            f()
            for x, old in zip(lists, before):
                x[:] = [jnp.where(pred, new, o) for new, o in zip(x, old)]

        return deco

    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    shim.when = when
    monkeypatch.setattr(jax_p3, "pl", shim)
    for name, value in dict(N=4352, K=1024, B=2, L=2).items():
        monkeypatch.setattr(jax_p3, name, value)


def _p3_chain(x, w, reps, packed):
    ck, k = (256, 512) if packed else (512, 1024)
    return np.asarray(pl.pallas_call(
        functools.partial(jax_p3._chain_kernel, reps=reps, packed=packed),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((2, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, ck, 4352), w.dtype),
                        pltpu.VMEM((k // ck, 2, 512), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=pltpu.InterpretParams(),
    )(x, w))


def test_bitcast_stream_matches_the_chain_kernel(p3_when_select):
    """P3b at L 2, K 1024, N 4352, B 2, 3 layer streams: `stream_plain` in
    both modes against `_chain_kernel` over the int8 source and over the
    script's own packing of it (viewed as bf16); the modes agree on the
    value and the checksum; the checksum is numpy's byte sum of columns
    4096 on."""
    rng = np.random.default_rng(3)
    w8 = rng.integers(-127, 127, (2, 1024, 4352), dtype=np.int8)
    wn = w8.astype(np.uint8).astype(np.uint16)
    packed = (wn[:, 0::2] | (wn[:, 1::2] << 8)).astype(np.uint16)  # the script's packing
    x = (rng.standard_normal((2, 1024)) * 0.1).astype(jnp.bfloat16)
    jx = jnp.asarray(x)
    want8 = _p3_chain(jx, jnp.asarray(w8), 3, False)
    wantp = _p3_chain(jx, jnp.asarray(packed.view(np.int16)).view(jnp.bfloat16), 3, True)
    np.testing.assert_array_equal(want8, wantp)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got8 = bitcast_pack.stream(xt, torch.from_numpy(w8), 3, False)
    gotp = bitcast_pack.stream(xt, torch.from_numpy(packed.view(np.int16)), 3, True)
    assert _rel(got8[0].numpy(), want8) <= REL
    assert torch.equal(got8[0], gotp[0]) and torch.equal(got8[1], gotp[1])
    rest = w8[:, :, 4096:].view(np.uint8).astype(np.int64).reshape(2, -1).sum(-1)
    total = (2 * rest[0] + rest[1]) % 2**32
    assert got8[1].item() == (total + 2**31) % 2**32 - 2**31
    assert got8[1].dtype == torch.int32


# -- P4 ---------------------------------------------------------------------------------


@pytest.fixture
def jax_p4(monkeypatch):
    """The P4 script, imported (or its constants cut) only while
    TOKENPACKER_FD_DEBUG=nodot is set by monkeypatch."""
    monkeypatch.setenv("TOKENPACKER_FD_DEBUG", "nodot")
    mod = importlib.import_module("scripts.probe_stream_dtype")
    for name, value in dict(L=2, N=256, K_BYTES=1024, CK_BYTES=512, B=2).items():
        monkeypatch.setattr(mod, name, value)
    return mod


def _p4_case(name, rng):
    dtype = {"int8": np.int8, "int16": np.int16, "uint16": np.uint16, "int32": np.int32,
             "bf16": jnp.bfloat16}[name]
    esize = np.dtype(dtype).itemsize
    k = 1024 // esize
    if name == "bf16":
        w = (rng.standard_normal((2, k, 256)) * 0.1).astype(dtype)
        x = (rng.standard_normal((2, k)) * 0.1).astype(dtype)
    elif name == "uint16":
        w = rng.integers(0, 60000, (2, k, 256)).astype(dtype)
        x = rng.integers(0, 60000, (2, k)).astype(dtype)
    else:
        w = rng.integers(-127, 127, (2, k, 256)).astype(dtype)
        x = rng.integers(-127, 127, (2, k)).astype(dtype)
    return x, w, k, esize


def _torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("name", ["int8", "int16", "uint16", "int32", "bf16"])
def test_stream_dtype_matches_the_nodot_kernel(jax_p4, name):
    """P4's value against `_kernel` with its products off (3 layer
    streams over 2 layers), and its checksum against numpy's sum of the
    streamed elements' unsigned bit patterns."""
    x, w, k, esize = _p4_case(name, np.random.default_rng(4))
    ck = 512 // esize
    reps = 3
    want = np.asarray(pl.pallas_call(
        functools.partial(jax_p4._kernel, reps=reps, k=k, ck=ck),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((2, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, ck, 256), w.dtype), pltpu.VMEM((k // ck, 2, ck), x.dtype),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(x), jnp.asarray(w)))
    value, checksum = stream_dtype.stream(_torch(x), _torch(w), reps)
    assert value.shape == (2, 1) and value.dtype == torch.float32
    if name == "bf16":
        # the TPU kernel rounds each chunk's sum (of 2 x ck values) to bf16
        chunks = np.asarray(x, np.float64).reshape(2, k // ck, ck).transpose(1, 0, 2)
        bound = reps * 256 * np.abs(chunks.reshape(k // ck, -1).sum(-1)).sum() * 2.0**-8
        assert np.abs(value.numpy().astype(np.float64) - want).max() <= bound
    else:
        assert _rel(value.numpy(), want) <= 1e-6
    bits = w.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[esize]).astype(np.int64)
    per = bits.reshape(2, -1).sum(-1)
    total = (2 * per[0] + per[1]) % 2**32
    assert checksum.dtype == torch.int32 and checksum.item() == (total + 2**31) % 2**32 - 2**31


# -- P1 ---------------------------------------------------------------------------------


@pytest.mark.parametrize("copies,col_off,width,small", [
    (1, 0, 11008, False),  # the script's contiguous source
    (1, 0, 176, True),  # a cut geometry: 64 rows of 88-byte slices, chunks of 8 rows
    (1, 88, 176, True),
    (3, 88, 176, True),
])
def test_dma_stride_checksum_matches_numpy(monkeypatch, copies, col_off, width, small):
    """The checksum of 21 chunks (chunk ci: copy (ci // 8) % C, rows (ci %
    8) * CK, columns [col_off, col_off + NCOLS)) against numpy's wrapping
    sum of those 32-bit words; the bytes a call are the script's."""
    assert dma_stride.bytes_per_call(21) == 21 * jax_p1.CK * jax_p1.NCOLS
    if small:
        for name, value in dict(NCOLS=88, NROWS=64, CK=8).items():
            monkeypatch.setattr(dma_stride, name, value)
    ncols, nrows, ck = dma_stride.NCOLS, dma_stride.NROWS, dma_stride.CK
    rng = np.random.default_rng(5)
    src = rng.integers(-128, 128, (copies, nrows, width), dtype=np.int8)
    reps = 21
    got = dma_stride.stream(torch.from_numpy(src), col_off, reps)
    total = 0
    for ci in range(reps):
        c, r = (ci // 8) % copies, (ci % 8) * ck
        words = src[c, r:r + ck, col_off:col_off + ncols].copy().view(np.uint32)
        total += int(words.astype(np.int64).sum())
    assert got.dtype == torch.int32 and got.item() == (total % 2**32 + 2**31) % 2**32 - 2**31
    assert dma_stride.l2_copies(4096 * 11008, 50 * 2**20) == 5  # 225 MB >= 4 x 50 MiB


# -- the modules ------------------------------------------------------------------------


def test_probe_mains_exit_without_a_card(monkeypatch):
    """Every probe's main() exits non-zero without a CUDA device, printing
    no rate."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mains = [lambda: dma_stride.main([]), int4_ring.main, lambda: stream_dtype.main([])]
    for what in ("semantics", "stream"):
        mains.append(lambda what=what: (monkeypatch.setattr(sys, "argv", ["probe", what]),
                                        bitcast_pack.main()))
    for main in mains:
        with pytest.raises(SystemExit) as exc:
            main()
        assert exc.value.code not in (0, None)
