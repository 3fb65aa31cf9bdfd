"""K1 on the card stores a 16-byte vector of ``prev`` only where its bytes
change (``csrc/logcompact.cu``, PREV STORES): every emission and instance
against its plain version, byte for byte, and the kernel's
``prev_stores`` count against the plain version's.

Marked ``card``: each test skips where there is no CUDA device. The file
imports no JAX; on a machine without it, leave the conftest out:

    python -m pytest --noconftest -m card tests/test_torch_k1_stores_card.py
"""

import json
import os

import numpy as np
import pytest
import torch

from cudavideostream_tpu_torch.ops import logcompact as lc

N_1080P = 1920 * 1080 * 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (entry point, keyword arguments, streams, frame bytes a stream, map)
EMISSIONS = {
    "flat": ("flat", {}, 1, N_1080P, False),
    "flat_map": ("flat", {}, 1, N_1080P, True),
    "flat_ragged": ("flat", {}, 1, 12_345, False),
    "tiled_sub1": ("tiled", dict(sub_rows=1), 1, N_1080P, False),
    "tiled_sub8": ("tiled", dict(sub_rows=8), 1, N_1080P, False),
    "tiled_sub0": ("tiled", dict(sub_rows=0), 1, N_1080P, False),
    "tiled_sub1_bits": ("tiled", dict(sub_rows=1, emit_bits=True), 1,
                        N_1080P, False),
    "tiled_sub1_map": ("tiled", dict(sub_rows=1), 1, N_1080P, True),
    "tiled_sub1_offset": ("tiled", dict(sub_rows=1,
                                        index_offset=3 * N_1080P // 4), 1,
                          N_1080P // 4, False),
    "mask_sub1": ("mask", dict(sub_rows=1), 1, N_1080P, False),
    "mask_sub0": ("mask", dict(sub_rows=0), 1, N_1080P, False),
    "batched_b4_sub1": ("batched", dict(sub_rows=1), 4, N_1080P, False),
    "batched_b4_sub0": ("batched", dict(sub_rows=0), 4, N_1080P, False),
    "batched_b3_ragged": ("batched", dict(sub_rows=1), 3, 1000, False),
}
ENTRY = {
    "flat": (lc.fused_diff_compact, lc.fused_diff_compact_reference),
    "tiled": (lc.fused_diff_compact_tiled,
              lc.fused_diff_compact_tiled_reference),
    "mask": (lc.fused_diff_compact_mask, lc.fused_diff_compact_mask_reference),
    "batched": (lc.fused_diff_compact_batched,
                lc.fused_diff_compact_batched_reference),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(emission, cur, prev, negfeed, tm):
    """The kernel's and the plain version's outputs, each on its own copy
    of ``prev``, with its ``prev_stores`` counter last."""
    entry, kw, streams, _, _ = EMISSIONS[emission]
    outs = []
    for fn in ENTRY[entry]:
        stores = torch.zeros(1, dtype=torch.int64, device=cur.device)
        args = (streams, 20, negfeed) if entry == "batched" else (20, negfeed)
        out = fn(cur, prev.clone(), *args, threshold_map=tm,
                 prev_stores=stores, **kw)
        torch.cuda.synchronize()
        outs.append(tuple(out) + (stores,))
    return outs


@pytest.mark.card
@pytest.mark.parametrize("negfeed", [True, False],
                         ids=["negfeed", "nofeed"])
@pytest.mark.parametrize("density", [0.0, 0.06, 1.0])
@pytest.mark.parametrize("emission", list(EMISSIONS))
def test_k1_stores_match_the_plain_version_card(emission, density, negfeed):
    """Outputs, state and ``prev_stores`` equal the plain version's on
    scattered changes (the ±15 noise past the threshold where it wraps)."""
    dev = _card()
    _, _, streams, n, with_map = EMISSIONS[emission]
    rng = np.random.default_rng([int(density * 100), streams, n])
    prev = rng.integers(0, 256, streams * n, dtype=np.uint8)
    delta = np.where(rng.random(prev.size) < density,
                     rng.integers(30, 200, prev.size),
                     rng.integers(-15, 16, prev.size))
    cur = ((prev.astype(np.int32) + delta) % 256).astype(np.uint8)
    tm = (torch.from_numpy(rng.integers(0, 40, n, dtype=np.uint8)).to(dev)
          if with_map else None)
    got, want = _both(emission, torch.from_numpy(cur).to(dev),
                      torch.from_numpy(prev).to(dev), negfeed, tm)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), f"output {i} differs"
    if density == 0.0 and negfeed and not with_map:
        assert int(got[-1]) < streams * -(-n // 16)  # most vectors kept


@pytest.mark.card
@pytest.mark.parametrize("emission", ["flat", "tiled_sub1", "mask_sub1",
                                      "batched_b4_sub1"])
def test_k1_stores_about_6pct_on_the_benchmark_scene_card(emission):
    """On the benchmark's scene (a band of 5.937% of the bytes changes a
    frame, ±10 noise) K1 stores about 6% of prev's vectors, as many as
    its plain version counts, over 4 chained frames."""
    from cvsbench import scene

    dev = _card()
    _, _, streams, n, _ = EMISSIONS[emission]
    name = "cam4" if streams == 4 else "cam1"
    with open(os.path.join(ROOT, "cvsbench", "traffic", f"{name}.json")) as f:
        traffic = dict(json.load(f), bank_frames=4)
    bank, base = scene.make_bank(traffic, 1080, 1920, 2900029002, dev)
    entry, kw, _, _, _ = EMISSIONS[emission]
    args = (streams, 20, True) if entry == "batched" else (20, True)
    prevs = [base.reshape(-1).clone() for _ in range(2)]
    for t in range(bank.shape[0]):
        counts = []
        for fn, prev in zip(ENTRY[entry], prevs):
            stores = torch.zeros(1, dtype=torch.int64, device=dev)
            fn(bank[t].reshape(-1), prev, *args, prev_stores=stores, **kw)
            torch.cuda.synchronize()
            counts.append(int(stores))
        assert counts[0] == counts[1]
        assert torch.equal(prevs[0], prevs[1])
        share = counts[0] / (streams * -(-n // 16))
        assert 0.055 <= share <= 0.065, share
