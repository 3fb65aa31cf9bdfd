"""The plain reference against the port's plain CPU step, the traffic
generator, and the roofline's arithmetic."""

import numpy as np
import pytest
import torch

from cvsbench import harness, reference, roofline, scene

TRAFFIC = {"streams": 2, "bank_frames": 6, "band_share": 0.05937339,
           "band_stride_bytes": 4096, "band_deltas": [77, 154],
           "noise_amplitude": 10}


def _stream(config, h, w):
    cell = harness.load_cell(config)
    return dict(cell.config["stream"], height=h, width=w), cell.config["text"]


@pytest.mark.parametrize("cell", ["cvs_1080p.cam1", "cvs_1080p_denoise.cam1"])
@pytest.mark.parametrize("size", [(48, 64), (64, 96)])
def test_reference_equals_port_plain_step(cell, size):
    from cudavideostream_tpu_torch.models import DeltaStreamPipeline

    stream, text = _stream(cell, *size)
    bank, base = scene.make_bank(TRAFFIC, *size, 11, "cpu")
    pipe = DeltaStreamPipeline(harness.stream_config(stream), device="cpu")
    step = reference.Step(stream, text)
    prev = base[0].clone()
    state = base[0].numpy().copy()
    h = size[0]
    for t in range(TRAFFIC["bank_frames"]):
        _, pos, counts, xs_t, vals_t, _ = pipe.step(prev, bank[t, 0], text)
        keep = torch.arange(xs_t.shape[1]) < counts.to(torch.int64)[:, None]
        cur = step.frame_rows(bank[t, 0].numpy(), 0, h)
        xs, vals = step.update(state, cur)
        assert int(pos) == xs.size
        np.testing.assert_array_equal(xs_t[keep].numpy(), xs)
        np.testing.assert_array_equal(vals_t[keep].numpy(), vals)
        np.testing.assert_array_equal(prev.numpy(), state)


def test_reference_equals_port_batched_step():
    from cudavideostream_tpu_torch.models import BatchedDeltaPipeline

    stream, text = _stream("cvs_1080p.cam4", 64, 96)
    bank, base = scene.make_bank(TRAFFIC, 64, 96, 12, "cpu")
    pipe = BatchedDeltaPipeline(harness.stream_config(stream), 2,
                                device="cpu")
    step = reference.Step(stream, text)
    prev = base.reshape(-1).clone()
    state = base.numpy().copy()
    for t in range(3):
        _, pos, counts, xs_t, vals_t, _ = pipe.step(prev, bank[t],
                                                    [text, text])
        for b in range(2):
            keep = (torch.arange(xs_t.shape[2])
                    < counts[b].to(torch.int64)[:, None])
            xs, vals = step.update(state[b],
                                   step.frame_rows(bank[t, b].numpy(), 0, 64))
            assert int(pos[b]) == xs.size
            np.testing.assert_array_equal(xs_t[b][keep].numpy(), xs)
            np.testing.assert_array_equal(vals_t[b][keep].numpy(), vals)
        np.testing.assert_array_equal(prev.numpy().reshape(2, -1), state)


@pytest.mark.parametrize("r0,r1", [(0, 7), (3, 20), (40, 48), (0, 48)])
def test_filter_bands_join(r0, r1):
    stream, text = _stream("cvs_1080p_denoise.cam1", 48, 64)
    step = reference.Step(stream, "")
    raw = np.random.default_rng(3).integers(0, 256, 48 * 64 * 3,
                                            dtype=np.uint8)
    whole = step.frame_rows(raw, 0, 48).reshape(48, -1)
    np.testing.assert_array_equal(
        step.frame_rows(raw, r0, r1).reshape(r1 - r0, -1), whole[r0:r1])


def test_traffic_deterministic_in_the_seed():
    a, base_a = scene.make_bank(TRAFFIC, 48, 64, 2**31 + 17, "cpu")
    b, base_b = scene.make_bank(TRAFFIC, 48, 64, 2**31 + 17, "cpu")
    c, _ = scene.make_bank(TRAFFIC, 48, 64, 2**31 + 18, "cpu")
    assert torch.equal(a, b) and torch.equal(base_a, base_b)
    assert not torch.equal(a, c)
    assert a.shape == (6, 2, 48 * 64 * 3) and a.dtype == torch.uint8


def test_traffic_density():
    """At a size where the band's drift is a small part of it, as at
    1080p, the step ships the band and the bytes it left: between
    band_share and band_share + stride / n of the frame; the noise
    alone never passes the threshold."""
    h, w = 270, 480
    n = h * w * 3
    tr = dict(TRAFFIC, streams=1)
    bank, base = scene.make_bank(tr, h, w, 5, "cpu")
    step = reference.Step(dict(_stream("cvs_1080p.cam1", h, w)[0]), "")
    state = base[0].numpy().copy()
    band = scene.band_bytes(tr, n)
    assert band == round(0.05937339 * n)
    shares = []
    for t in range(tr["bank_frames"]):
        xs, _ = step.update(state, bank[t, 0].numpy())
        shares.append(xs.size / n)
    for s in shares[1:]:
        assert band / n <= s <= (band + 4096) / n
    assert roofline.step_least_bytes(6220800, 373000) == (
        2 * 6220800 + 2 * 373000 + 777600)


def test_noise_stays_under_the_threshold():
    tr = dict(TRAFFIC, streams=1, band_deltas=[0])  # the noise alone
    bank, base = scene.make_bank(tr, 48, 64, 9, "cpu")
    d = (bank[1:].to(torch.int16) - bank[:-1].to(torch.int16)).abs()
    assert int(d.max()) == 20
    d0 = (bank.to(torch.int16) - base.to(torch.int16)).abs()
    assert int(d0.max()) == 10


@pytest.mark.parametrize("n,pos,want", [
    (6220800, 0, 2 * 6220800 + 777600),
    (9216, 100, 2 * 9216 + 200 + 1152),
    (9, 1, 18 + 2 + 2),  # the bitmask rounds up to whole bytes
])
def test_least_bytes(n, pos, want):
    assert roofline.step_least_bytes(n, pos) == want
    # a visualizer writes its n-byte aux frame too
    assert roofline.step_least_bytes(n, pos, aux=True) == \
        roofline.step_least_bytes(n, pos) + n


def test_filter_least_time():
    n = 6220800
    by_bytes = 2 * n / roofline.HBM_BYTES_PER_S
    assert roofline.filter_least_s(n, 3) == by_bytes
    assert roofline.filter_least_s(n, 9) == 81 * n / \
        roofline.INT32_MACS_PER_S
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None
