"""The decoder's one input path (``models/decoder.py::FrameMap``): every
decoder call reads its frames through a map, each site projecting each
distinct frame once. ``models/meta.py::decode_clips_batched`` builds the VIS
decode's map on the host (``clip_frame_map``) and uploads it with the batch;
called without a map, the decoder builds one on the device whose rows are
their own frames (``own_frame_map``). On the CPU at a tiny size, against
the decoder called without a map on every clip-frame row (the oracle): the
same slabs, the counters ``vis.decode_rows`` / ``vis.decode_proj_frames``;
the two map builders against each other, the relative-position grid
against the JAX package's, no span or synchronizing call inside the
decoder, and a training step after VIS inference in one process."""
import inspect

import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu_torch.models import attention, meta
from mdqe_cvpr2023_tpu_torch.models.decoder import (clip_frame_map, own_frame_map,
                                                    query_relpos_grid, tca_frames)
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
from mdqe_cvpr2023_tpu_torch.utils import tracing

torch.set_num_threads(2)

TINY = dict(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4, enc_layers=1,
            dec_layers=2, n_query=16, query_embed_dim=8, dec_temporal=True)
WINDOW = 12          # frames of the fabricated window
HW, PADDED = (50, 58), (64, 64)
SLAB = dict(apply_cls_thres=0.0, topk=8, dedup_sim=0.99)
FIELDS = ("scores", "cls_probs", "masks", "query_embeds", "valid")


@pytest.fixture(scope="module")
def models():
    return {nf: MDQEModel(MDQEModelCfg(**TINY, n_frames=nf), device="cpu", seed=nf)
            for nf in (2, 4)}


@pytest.fixture(scope="module")
def windows(models):
    """A window's encodings, padding mask and mask features for each model:
    frames smaller than their padding, so the mask holds padded tokens."""
    rng = np.random.default_rng(0)
    frames = np.zeros((WINDOW,) + PADDED + (3,), np.uint8)
    frames[:, :HW[0], :HW[1]] = rng.integers(0, 255, (WINDOW,) + HW + (3,))
    sizes = torch.tensor([HW] * WINDOW, dtype=torch.int32)
    mean = torch.tensor((123.675, 116.28, 103.53))
    std = torch.tensor((58.395, 57.12, 57.375))
    out = {}
    with torch.inference_mode():
        for nf, model in models.items():
            shapes = meta.spatial_shapes_for(model.cfg, PADDED)
            enc, mflat, maskf = meta.encode_window(model.detr, torch.from_numpy(frames), sizes,
                                                   mean, std, shapes)
            assert mflat.any() and not mflat.all()
            out[nf] = (enc, mflat, maskf, shapes)
    return out


def per_clip_decode(model, enc, mflat, maskf, offsets, shapes, T):
    """The decoder called without a frame map on every clip-frame row
    gathered: the rows are their own frames, each projected on its own."""
    S = len(offsets)
    idx = torch.tensor([o + t for o in offsets for t in range(T)])
    mfe = maskf.index_select(0, idx)
    out = model.detr.transformer_dec(enc.index_select(0, idx), mflat.index_select(0, idx),
                                     shapes, T)
    return meta.postprocess_clip(out["cls"], out["mask_coeff"], out["query_embed"],
                                 mfe.reshape(S, T, *mfe.shape[1:]), SLAB["apply_cls_thres"],
                                 SLAB["topk"], SLAB["dedup_sim"])


def _clamped(starts, T):
    """Offsets as ``_inference_vis`` clamps them into the window, the batch
    padded with its last clip to ``S_BATCH``."""
    offs = [min(max(s, 0), WINDOW - T) for s in starts]
    return offs + offs[-1:] * (meta.S_BATCH - len(offs))


# (model's training frames, clip frames T, offsets, distinct frames F)
CASES = {
    "full_stride1": (4, 4, list(range(8)), 11),
    "padded_tail": (4, 4, _clamped([0, 1, 2], 4), 6),
    "window_clamped_tail": (2, 2, _clamped([-1, 0, 1], 2), 3),
    "tca_subset": (2, 4, list(range(8)), 11),            # tca_frames(4, 2) == [1, 3]
    "tca_padded": (4, 2, list(range(8)), 9),             # tca_frames(2, 4) == [0, 1] + [1, 1]
    "no_shared_frames": (2, 2, [0, 2, 4, 6, 8, 10], 12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_map_decode_matches_the_per_clip_decode(models, windows, case):
    nf, T, offsets, F = CASES[case]
    model = models[nf]
    enc, mflat, maskf, shapes = windows[nf]
    with torch.inference_mode():
        with tracing.request("vis.test") as req:
            got = meta.decode_clips_batched(model, enc, mflat, maskf, offsets, shapes, T,
                                            **SLAB)
        want = per_clip_decode(model, enc, mflat, maskf, offsets, shapes, T)
    for k in FIELDS:
        assert got[k].shape == want[k].shape, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6, msg=k)
    assert torch.equal(got["valid"], want["valid"])
    assert req.counters["vis.decode_rows"] == len(offsets) * T
    assert req.counters["vis.decode_proj_frames"] == F
    assert "decoder.tca.wait" not in req.spans
    # the map rides in the decode's one upload and the decoder uploads
    # nothing: the decode's syncs are that upload and the slab's constant
    assert req.counters["vis.syncs"] == 2


def test_clip_frame_map_indexes_each_row_and_temporal_level():
    rows = [o + t for o in (3, 4, 4) for t in range(4)]
    frames, at, tca = clip_frame_map(rows, 4, 2)
    assert frames == [3, 4, 5, 6, 7]
    assert [frames[i] for i in at] == rows
    levels = tca_frames(4, 2)
    assert [frames[i] for i in tca] == [o + t for o in (3, 4, 4) for t in levels]
    _, _, tca = clip_frame_map([0, 1, 1, 2], 2, 4)          # levels padded with the last
    assert tca == [0, 1, 1, 1, 1, 2, 2, 2]


@pytest.mark.parametrize("B,T,n_frames_train", [(2, 4, 4), (2, 2, 4), (1, 1, 4), (2, 4, 2)])
def test_own_frame_map_is_the_host_map_of_rows_that_are_their_own_frames(B, T,
                                                                          n_frames_train):
    frames, rows, tca = clip_frame_map(range(B * T), T, n_frames_train)
    fm = own_frame_map(B * T, T, n_frames_train, "cpu")
    assert frames == rows == list(range(B * T))
    assert fm.rows.dtype == fm.tca.dtype == torch.long
    assert fm.rows.tolist() == rows
    assert fm.tca.tolist() == tca


@pytest.mark.parametrize("n_bins", [4, 14])
def test_relpos_grid_on_the_device_matches_jax(n_bins):
    from mdqe_cvpr2023_tpu.models.decoder import query_relpos_grid as jax_grid
    got = query_relpos_grid(n_bins, "cpu")
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_grid(n_bins)))


# the three VIS cells' schedules: (video frames, T, window, training frames,
# distinct frames projected, clip-frame rows) over a video's decode batches
SCHEDULES = {
    "r50_ovis360": (36, 4, 30, 4, 48, 160),
    "swinl_ovis": (36, 2, 20, 2, 40, 80),
    "r50_ovis720": (100, 4, 20, 4, 148, 544),
}


@pytest.mark.parametrize("cell", sorted(SCHEDULES))
def test_a_video_counts_the_frames_its_decode_projects(cell):
    """``inference_vis`` over the cell's schedule at a tiny frame size: the
    counters over the video, and no list index uploaded by the decoder."""
    n, T, W, nf, F, rows = SCHEDULES[cell]
    model = MDQEModel(MDQEModelCfg(**dict(TINY, dec_layers=1), n_frames=nf), device="cpu",
                      seed=0)
    inf = meta.InferenceCfg(clip_stride=1, n_frames_test=T, n_frames_window_test=W,
                            max_num_instances=20, apply_cls_thres=0.05, clip_topk=8,
                            encode_chunk=10, num_classes=5, bf16_encode=False)
    video = np.random.default_rng(1).integers(0, 255, (n, 32, 32, 3)).astype(np.uint8)
    frames, _ = meta.preprocess_frames(video)
    meta.inference_vis(model, inf, frames, (32, 32), (32, 32), device="cpu")
    req = tracing.last("vis.video")
    assert req.counters["vis.decode_rows"] == rows
    assert req.counters["vis.decode_proj_frames"] == F
    assert req.counters["vis.clips"] * T <= rows
    assert "decoder.tca.wait" not in req.spans


@pytest.fixture
def value_rows_seen(monkeypatch):
    """The ``value_rows`` of every ``MSDeformAttn`` call, by site."""
    seen = []
    forward = attention.MSDeformAttn.forward

    def spy(self, *args, **kw):
        rows = kw.get("value_rows", args[5] if len(args) > 5 else None)
        seen.append((self.site, rows))
        return forward(self, *args, **kw)

    monkeypatch.setattr(attention.MSDeformAttn, "forward", spy)
    return seen


@pytest.mark.parametrize("path", ["forward_train", "coco"])
def test_training_and_coco_decode_read_through_the_frame_map(models, windows, value_rows_seen,
                                                             path):
    """Called without a map, the decoder reads its rows through the map it
    builds on the device: every site gets rows, and the decoder opens no
    span and makes no synchronizing call."""
    model = models[2]
    enc, mflat, _, shapes = windows[2]
    dec = model.detr.transformer_dec
    T = 1 if path == "coco" else 2
    with tracing.request("train.test") as req:
        if path == "coco":
            with torch.inference_mode():
                dec(enc[:1], mflat[:1], shapes, T, is_coco=True)
        else:
            dec.forward_train(enc[:4], mflat[:4], shapes, T)
    sites = [s for s, _ in value_rows_seen]
    assert sites == ["decoder_box", "decoder_inst"] * TINY["dec_layers"]
    assert all(isinstance(rows, torch.Tensor) for _, rows in value_rows_seen)
    assert not [n for n in req.spans if n.startswith("decoder.")]
    assert not [n for n in req.spans if n.endswith(".wait")]
    assert not req.counters.get("train.syncs")


def _trainable_model():
    model = MDQEModel(MDQEModelCfg(**TINY, n_frames=2), device="cpu", seed=5)
    model.set_trainable()
    return model


def _train_grads(model, enc, mflat, shapes, T):
    out = model.detr.transformer_dec.forward_train(enc, mflat, shapes, T)
    loss = sum(out[k].sum() for k in ("cls", "boxes", "mask_coeff", "proto"))
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def test_training_after_inference_in_one_process_matches_a_fresh_model(windows):
    """Whatever the decoder makes on the device under ``inference_mode`` (the
    map, the relative-position grid) leaves a later training step's
    gradients as a fresh model's."""
    enc, mflat, _, shapes = windows[2]
    enc, mflat = enc[:4].clone(), mflat[:4].clone()   # normal tensors: autograd saves them
    used = _trainable_model()
    with torch.inference_mode():
        used.detr.transformer_dec(enc, mflat, shapes, 2)
    got = _train_grads(used, enc, mflat, shapes, 2)
    want = _train_grads(_trainable_model(), enc, mflat, shapes, 2)
    assert got.keys() == want.keys() and len(got) > 0
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_decode_clips_batched_keeps_its_signature():
    """The benchmark wraps ``decode_clips_batched`` by name and positional
    arguments."""
    params = list(inspect.signature(meta.decode_clips_batched).parameters)
    assert params == ["model", "window_encoded", "window_mask_flat", "window_mask_feats",
                      "offsets", "spatial_shapes", "n_frames", "apply_cls_thres", "topk",
                      "dedup_sim"]
