"""Packed batches on the CPU: ``ShardedExtractor._pack_rows`` (only the
real samples, back to back) laid out by the plain version of the layout
kernel (``stft_kernels.layout_rows_plain``) against the host padding of
``_pad_rows``, element for element; extraction through the packed path
against the host-padding path, bit for bit, each path padding or packing
alone.

On a CPU device the extractor pads on the host; these tests switch the
packed path on by hand (``_packs``), which a GPU device takes.  The kernel
itself runs in ``tests/test_torch_gpu.py``.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from speech_tpu_torch import parallel as tpar
from speech_tpu_torch.compute import SIFrameComputer, STFTFrameComputer
from speech_tpu_torch.ops import stft_kernels as K
from speech_tpu_torch.parallel import multihost
from speech_tpu_torch.serve import FeatureServer

BANK = {"name": "fbank", "num_filts": 12, "sampling_rate": 8000}
SI_BANK = {"name": "gammatone", "scaling_function": "mel", "num_filts": 8,
           "sampling_rate": 8000}


def _stft(**kw):
    return STFTFrameComputer(dict(BANK), frame_length_ms=25, frame_shift_ms=10,
                             device="cpu", **kw)


def _signals(dtype, lengths, seed=0):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(dtype)
        return [rng.randint(info.min, int(info.max) + 1, size=n).astype(dtype) for n in lengths]
    sigs = [(rng.randn(n) * 1000).astype(dtype) for n in lengths]
    sigs[0][:2] = [-0.0, np.nan]  # copied as they are, bit for bit
    return sigs


def _bits(t):
    """The tensor's raw bits, so that NaN and -0.0 compare as bits."""
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


# (signal dtype, buffer dtype): int16 PCM as it is, compact uint8 widened to
# int16, float32 and float64 as they are, and the casts either way
DTYPES = [(np.int16, torch.int16), (np.uint8, torch.int16), (np.float32, torch.float32),
          (np.float64, torch.float64), (np.float32, torch.float64), (np.float64, torch.float32)]
# (first row, rows): the whole batch, a mesh block past the first rows, a
# block of the last real row and batch-padding rows, a block of padding only
BLOCKS = [(0, 8), (2, 3), (4, 4), (6, 2)]


@pytest.mark.parametrize("block", BLOCKS, ids=[f"rows{s}+{p}" for s, p in BLOCKS])
@pytest.mark.parametrize("dtypes", DTYPES, ids=[f"{np.dtype(a).name}-{str(b)[6:]}"
                                                for a, b in DTYPES])
def test_pack_and_layout_equal_host_padding(dtypes, block):
    sig_dtype, buf_dtype = dtypes
    start, per = block
    ex = tpar.ShardedExtractor(_stft())
    sigs = _signals(sig_dtype, [900, 1501, 37, 2801, 0], seed=start)
    lengths, max_len, _ = ex._host_batch(sigs, min_batch=8)
    want = ex._pad_rows(sigs, lengths, max_len, buf_dtype, start, per)
    packed, table = ex._pack_rows(sigs, lengths, buf_dtype, start, per)
    assert packed.dtype == buf_dtype and packed.dim() == 1 and table.dtype == torch.int64
    lens, offsets, counts = table
    real = [len(s) for s in sigs[start: start + per]]
    assert lens.tolist() == lengths[start: start + per].tolist()
    assert counts.tolist() == real + [0] * (per - len(real))
    assert packed.numel() >= int(counts.sum())
    # each row from a 16-byte boundary, after the rows before it
    assert (offsets * packed.element_size() % 16 == 0).all()
    assert (offsets[1:] >= offsets[:-1] + counts[:-1]).all()
    got = K.layout_rows(packed, offsets, counts, max_len)
    assert got.dtype == want.dtype and got.shape == want.shape == (per, max_len)
    assert torch.equal(_bits(got), _bits(want))


def test_layout_rows_plain_clamps_and_validates():
    packed = torch.arange(1, 11, dtype=torch.float32)
    offsets = torch.tensor([0, 3, 8, 12], dtype=torch.int64)
    counts = torch.tensor([2, 9, 5, 4], dtype=torch.int64)
    got = K.layout_rows(packed, offsets, counts, 6)
    # counts clamp to max_len and to the packed elements past the offset
    want = torch.tensor([[1, 2, 0, 0, 0, 0], [4, 5, 6, 7, 8, 9], [9, 10, 0, 0, 0, 0],
                         [0, 0, 0, 0, 0, 0]], dtype=torch.float32)
    assert torch.equal(got, want)
    assert K.layout_rows(packed, offsets[:0], counts[:0], 6).shape == (0, 6)
    with pytest.raises(ValueError, match="1-D"):
        K.layout_rows(packed[None], offsets, counts, 6)
    with pytest.raises(ValueError, match="2, 4 or 8 bytes"):
        K.layout_rows(packed.to(torch.int8), offsets, counts, 6)
    with pytest.raises(ValueError, match="int64"):
        K.layout_rows(packed, offsets.int(), counts, 6)
    with pytest.raises(ValueError, match="differ"):
        K.layout_rows(packed, offsets, counts[:2], 6)


def _computer(kind):
    if kind == "si":
        return SIFrameComputer(dict(SI_BANK), frame_shift_ms=10, include_energy=True,
                               device="cpu")
    if kind == "float64":
        return _stft(dtype="float64", include_energy=True)
    return _stft(precision="double", include_energy=True)


# (computer, signal dtype): B2's route at 'double' on int16 PCM, SI (which
# needs zero padding) on float32, a float64 computer on float32 (the cast)
ROUTES = [("double", np.int16), ("si", np.float32), ("float64", np.float32)]


@pytest.mark.parametrize("kind,sig_dtype", ROUTES, ids=[k for k, _ in ROUTES])
def test_packed_extract_iter_matches_host_padding(kind, sig_dtype):
    """extract_iter through the packed path: the features of the
    host-padding path bit for bit, a long batch before a short one; the
    packed path never pads on the host, the host path never packs."""
    lengths = [[3000, 700, 4100], [500, 1200, 333], [2900, 2000, 1024]]
    batches = [_signals(sig_dtype, n, seed=i) for i, n in enumerate(lengths)]
    if sig_dtype != np.int16:
        for b in batches:
            b[0][:2] = 0.5  # no NaN in the features
    host = tpar.ShardedExtractor(_computer(kind))
    packed = tpar.ShardedExtractor(_computer(kind))
    packed._packs = True
    assert not host._packs  # a CPU device pads on the host
    host._pack_rows = packed._pad_rows = None  # a call would raise
    want = list(host.extract_iter(batches, min_batch=4))
    got = list(packed.extract_iter(batches, min_batch=4))
    for w, g in zip(want, got):
        assert len(w) == len(g) == 3
        for a, b in zip(w, g):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert packed.stats == host.stats
    assert packed.stats["samples"] == sum(map(sum, lengths))


def test_packed_relayed_feature_server_matches_host_padding(tmp_path):
    """FeatureServer on a world-size-1 mesh (the relay path: the front
    lays out the whole batch, then takes its block) through the packed
    path: the host-padding server's features bit for bit."""
    rng = np.random.RandomState(8)
    sigs = [rng.randn(int(n)).astype(np.float32) for n in rng.randint(300, 4000, 9)]
    multihost.initialize(store=dist.FileStore(os.path.join(str(tmp_path), "store1"), 1),
                         num_processes=1, process_id=0, backend="gloo")
    try:
        mesh = tpar.make_mesh(("data",), devices="cpu")
        outs = []
        for packs in (False, True):
            with FeatureServer(_stft(precision="double"), mesh=mesh, max_batch=4,
                               max_wait_ms=10.0) as server:
                assert server._relay.front
                server._extractor._packs = packs
                outs.append(server.extract_many(sigs))
    finally:
        dist.destroy_process_group()
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
