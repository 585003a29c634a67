"""The port's zstd decoder (``vqa_tpu_torch/native/zstd_decode.cc``)
against the ``zstandard`` package, on the CPU.

Every frame ``zstandard`` writes at levels 1, 3, 9, 19 and 22, with and
without a checksum and a content size, decodes to the same bytes: empty,
one byte, 128 KiB and one byte either side (the block size), a few MB of
random bytes, repetitive text, float32 weights, and inputs shaped to take
the rarer paths (RLE blocks, RLE literals, one-stream Huffman literals,
more than 32,511 sequences in a block). So do several frames in a row, a
skippable frame, and every zstd frame of the committed Orbax fixture (its
zarr chunks and B-tree nodes). A truncated frame, a flipped byte in a
checksummed frame and a wrong expected size each raise. The file is
skipped where ``zstandard`` is absent, as on the card's machine.
"""

import functools
import os

import numpy as np
import pytest

zstandard = pytest.importorskip("zstandard")

from vqa_tpu_torch.compat import ocdbt  # noqa: E402
from vqa_tpu_torch.native import zstd  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "orbax_narrow", "best_model")
LEVELS = [1, 3, 9, 19, 22]
FLAGS = [(False, False), (False, True), (True, False), (True, True)]  # checksum, size


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    block = 128 * 1024
    base = rng.integers(0, 256, block, dtype=np.uint8).tobytes()
    # a second block made of pieces of the first, each after the byte 'Q':
    # its literals are all 'Q' (RLE literals), its matches reach back a block
    pieces, n = [], 0
    while n < 200_000:
        o, k = int(rng.integers(0, block - 64)), int(rng.integers(20, 50))
        pieces.append(b"Q" + base[o:o + k])
        n += k + 1
    tokens = [rng.integers(0, 256, 3, dtype=np.uint8).tobytes() for _ in range(1000)]
    return {
        "empty": b"",
        "one_byte": b"x",
        "block_minus_one": rng.integers(0, 256, block - 1, dtype=np.uint8).tobytes(),
        "block": rng.integers(0, 4, block, dtype=np.uint8).tobytes(),
        "block_plus_one": (b"abcdefgh" * 20000)[:block + 1],
        "random_mb": rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes(),
        "repetitive": b"what color is the cat? " * 60000,
        "float32_weights": (rng.standard_normal(1 << 19) * 0.02).astype(np.float32).tobytes(),
        "short_text": b"the cat sat on the mat and the dog ate the hat; zebra quagga",
        "zeros": bytes(1 << 20),
        "rle_literals": base + b"".join(pieces),
        "many_sequences": b"".join(tokens[i] for i in rng.integers(0, 1000, 100_000)),
    }


@functools.lru_cache(maxsize=None)
def _frame(name, level, checksum, content_size):
    compressor = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                          write_content_size=content_size)
    return compressor.compress(_inputs()[name])


# the slow levels take the multi-MB inputs with one flag setting only
CASES = [pytest.param(name, level, flags, id=f"{name}-level{level}"
                      f"{'-checksum' if flags[0] else ''}{'-size' if flags[1] else ''}")
         for level in LEVELS for name in (
             "empty", "one_byte", "block_minus_one", "block", "block_plus_one", "random_mb",
             "repetitive", "float32_weights", "short_text", "zeros", "rle_literals",
             "many_sequences")
         for flags in (FLAGS if level < 19 or name in ("empty", "one_byte", "short_text")
                       else [(True, True)])]


@pytest.mark.parametrize("name,level,flags", CASES)
def test_frames_decode_as_zstandard_does(name, level, flags):
    frame = _frame(name, level, *flags)
    want = _inputs()[name]
    assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=len(want) + 1) == want
    assert zstd.decompress(frame, len(want)).tobytes() == want
    assert zstd.content_size(frame) == (len(want) if flags[1] else None)


def test_several_frames_in_a_row_and_a_skippable_frame():
    parts = [b"first frame " * 100, b"", b"x", bytes(range(256)) * 50]
    frames = [zstandard.ZstdCompressor(level=3 + i, write_checksum=i % 2 == 0).compress(p)
              for i, p in enumerate(parts)]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    data = frames[0] + skippable + frames[1] + frames[2] + frames[3]
    want = b"".join(parts)
    assert zstd.decompress(data, len(want)).tobytes() == want
    assert zstd.content_size(data) == len(want)


def test_a_wrong_size_a_truncated_frame_and_a_flipped_byte_raise():
    data = _inputs()["float32_weights"][:200_000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for size in (len(data) - 1, len(data) + 1, 0):
        with pytest.raises(zstd.ZstdError, match="expected"):
            zstd.decompress(frame, size)
    for cut in (1, 5, 17, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut], len(data))
    # past the magic, the header descriptor and the window size, which the
    # decoder does not need (a flip there is not an error in any decoder)
    rng = np.random.default_rng(1)
    for pos in rng.choice(np.arange(6, len(frame)), 40, replace=False):
        for bit in (0, 5):
            broken = bytearray(frame)
            broken[pos] ^= 1 << bit
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(bytes(broken), len(data))
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"\x00" * 16, 4)


@pytest.mark.parametrize("level", [1, 19])
def test_damaged_frames_raise_or_decode_to_their_size(level):
    """Seeded damage to frames without a checksum (so that some of it
    decodes): flipped bits, bytes overwritten, a slice cut out or doubled,
    garbage appended. Each frame either raises ``ZstdError`` or decodes to
    exactly the size asked for; the process survives every one."""
    rng = np.random.default_rng(level)
    inputs = _inputs()
    for name, n in (("short_text", None), ("float32_weights", 20_000),
                    ("rle_literals", 140_000), ("many_sequences", 60_000),
                    ("repetitive", 30_000)):
        data = inputs[name][:n]
        frame = zstandard.ZstdCompressor(level=level, write_checksum=False).compress(data)
        decoded = 0
        for i in range(300):
            broken = bytearray(frame)
            at = int(rng.integers(4, len(frame)))
            kind = i % 5
            if kind == 0:
                broken[at] ^= 1 << int(rng.integers(0, 8))
            elif kind == 1:
                broken[at] = int(rng.integers(0, 256))
            elif kind == 2:
                del broken[at:at + int(rng.integers(1, 16))]
            elif kind == 3:
                broken[at:at] = broken[at:at + int(rng.integers(1, 16))]
            else:
                broken += rng.integers(0, 256, int(rng.integers(1, 64)), np.uint8).tobytes()
            try:
                out = zstd.decompress(bytes(broken), len(data))
            except zstd.ZstdError:
                continue
            assert out.size == len(data), (name, i)
            decoded += 1
        assert decoded < 300, name  # the damage was seen at least once


def test_many_frames_decode_across_the_thread_pool():
    datas = [_inputs()[k] for k in ("block", "repetitive", "float32_weights", "empty")] * 3
    frames = [zstandard.ZstdCompressor(level=1 + i).compress(d) for i, d in enumerate(datas)]
    sizes = [len(d) for d in datas]
    outs = zstd.decompress_many(frames, sizes, num_threads=4)
    assert [o.tobytes() for o in outs] == datas
    assert all(o.ctypes.data % zstd.ALIGN == 0 for o in outs)
    sizes[5] += 1
    with pytest.raises(zstd.ZstdError, match="input 5 of 12"):
        zstd.decompress_many(frames, sizes, num_threads=4)


def test_the_frames_of_a_real_orbax_save():
    """The committed fixture's zarr chunks and its compressed B-tree node
    bodies: the decoder and ``zstandard`` give the same bytes."""
    chunks = {k: bytes(v) for k, v in ocdbt.read_store(FIXTURE).items()
              if not k.endswith(b".zarray")}
    assert len(chunks) > 300
    for key, frame in chunks.items():
        want = zstandard.ZstdDecompressor().decompress(frame, max_output_size=1 << 24)
        assert zstd.decompress(frame, len(want)).tobytes() == want, key
    nodes = [os.path.join(FIXTURE, "d", f) for f in os.listdir(os.path.join(FIXTURE, "d"))]
    for path in nodes:
        with open(path, "rb") as f:
            data = f.read()
        assert data[13] == 1  # zstd-compressed node
        body = data[14:-4]
        want = zstandard.ZstdDecompressor().decompress(body, max_output_size=1 << 26)
        assert zstd.decompress_bounded(body, 1 << 26).tobytes() == want
