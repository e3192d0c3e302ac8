"""The VIS merge of ``models/meta.py::inference_vis``: the results' masks
assembled on the device (``_merge_masks``) against the host assembly it
replaced, kept here as the oracle: every deferred window's selected rows
finalized and bit-packed on the device, every window's packed rows read to
the host, each result unpacked window by window with numpy, zeros where a
window lacks its row, and concatenated.

The CPU cases run the tiny model; the test marked ``cuda`` runs the R50
geometry of ``tools/profile_vis.py`` on a card and imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_vis_merge.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from mdqe_cvpr2023_tpu_torch.models import meta
from mdqe_cvpr2023_tpu_torch.models.detr import MDQEModel, MDQEModelCfg
from mdqe_cvpr2023_tpu_torch.tracking import mask_memory
from mdqe_cvpr2023_tpu_torch.utils import tracing

torch.set_num_threads(2)

TINY = dict(backbone="resnet50", num_classes=5, hidden_dim=64, n_heads=4, enc_layers=1,
            dec_layers=1, n_frames=2, n_query=16, query_embed_dim=8, dec_temporal=True)
INF = meta.InferenceCfg(clip_stride=2, n_frames_test=2, n_frames_window_test=4,
                        max_num_instances=20, apply_cls_thres=0.05, clip_topk=8,
                        encode_chunk=2, num_classes=5, bf16_encode=False)
# the gates open: the tracker fills, so rows come and go between windows
CROWD = dataclasses.replace(INF, apply_cls_thres=0.0, dedup_sim=2.0, suppress_siou=2.0,
                            suppress_ctt=2.0)


def host_merge(inst_idx, windows, inf, image_size, ori_size, real_len):
    """The oracle: the masks as the merge assembled them on the host."""
    sel_rows = sorted({int(r) for r in inst_idx})
    win_masks = []
    for kind, n, src, len_frames in windows:
        if kind == "packed":
            host = src.cpu().numpy() if n else None
            win_masks.append({r: host[r] for r in range(n)})
            continue
        rows = [r for r in sel_rows if r < n]
        host = None
        if rows:
            idx = torch.as_tensor(rows, device=src.device)
            parts = [mask_memory.finalize_from_avg(
                src.index_select(0, idx[c:c + meta.FINALIZE_CHUNK]), inf.match_stride,
                image_size, ori_size) for c in range(0, len(rows), meta.FINALIZE_CHUNK)]
            host = torch.cat(parts)[:, :len_frames].cpu().numpy()
        win_masks.append({r: host[a] for a, r in enumerate(rows)})
    out = []
    for r in inst_idx:
        parts = []
        for rowmap, (_, _, _, len_frames) in zip(win_masks, windows):
            m = rowmap.get(int(r))
            parts.append(np.zeros((len_frames,) + tuple(ori_size), bool) if m is None
                         else np.unpackbits(m, axis=-1)[..., :ori_size[1]].view(bool))
        out.append(np.concatenate(parts, axis=0)[:real_len])
    return out


@pytest.fixture
def merges(monkeypatch):
    """Each ``_merge_masks`` call's arguments and the oracle's masks."""
    seen = []
    merge = meta._merge_masks

    def spy(inst_idx, windows, inf, image_size, ori_size, real_len, dev):
        seen.append({"inst_idx": [int(r) for r in inst_idx], "windows": windows,
                     "want": host_merge(inst_idx, windows, inf, image_size, ori_size,
                                        real_len)})
        return merge(inst_idx, windows, inf, image_size, ori_size, real_len, dev)
    monkeypatch.setattr(meta, "_merge_masks", spy)
    return seen


def check_merge(out, merge, shape):
    """``out``'s masks bit-equal to the oracle's, each a C-contiguous bool
    ``shape`` array that shares no memory with another."""
    got, want = out["pred_masks"], merge["want"]
    assert len(got) == len(want) == len(out["pred_scores"]) == len(merge["inst_idx"]) > 0
    for g, w in zip(got, want):
        assert g.dtype == bool and g.shape == w.shape == shape and g.flags.c_contiguous
        np.testing.assert_array_equal(g, w)
    before = [m.copy() for m in got]
    got[0][...] = ~got[0]
    assert all(np.array_equal(m, b) for m, b in zip(got[1:], before[1:]))
    got[0][...] = before[0]


@pytest.fixture(scope="module")
def tiny_model():
    return MDQEModel(MDQEModelCfg(**TINY), device="cpu", seed=0)


def _absent(merge):
    """A result whose row some window does not have."""
    return any(r >= n for r in merge["inst_idx"] for _, n, _, _ in merge["windows"])


# case: (gates, frames, original size, slab budget, what the case must show)
CASES = {
    "windows": (INF, 9, (120, 124), None, lambda m: len(m["windows"]) >= 3),
    "finalized_early": (CROWD, 11, (61, 83), 1,
                        lambda m: [w[0] for w in m["windows"]].count("packed") >= 1),
    "shorter_than_a_clip": (INF, 1, (60, 62), None, lambda m: len(m["windows"]) == 1),
    "width_not_a_multiple_of_8": (CROWD, 7, (60, 61), None, lambda m: True),
    "row_under_two_labels": (INF, 9, (64, 64), None,
                             lambda m: len(set(m["inst_idx"])) < len(m["inst_idx"])),
    "row_absent_from_a_window": (CROWD, 11, (60, 62), None, _absent),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_on_the_device_equals_the_host_merge(tiny_model, merges, case):
    inf, n_frames, ori, budget, shows = CASES[case]
    if budget is not None:
        inf = dataclasses.replace(inf, slab_hbm_budget=budget)
    video = np.random.default_rng(3).integers(0, 255, (n_frames, 60, 62, 3)).astype(np.uint8)
    out = meta.inference_vis(tiny_model, inf, meta.preprocess_frames(video)[0], (60, 62),
                             ori, device="cpu")
    assert len(merges) == 1 and shows(merges[0]), merges[0]["inst_idx"]
    check_merge(out, merges[0], (n_frames,) + ori)
    req = tracing.last("vis.video")
    video_len = max(n_frames, inf.n_frames_test)
    assert req.counters["vis.merge_results"] == len(out["pred_scores"])
    assert req.counters["vis.merge_bytes"] == len(out["pred_masks"]) * video_len * ori[0] * ori[1]


@pytest.mark.parametrize("width", [1, 8, 13, 61, 854])
def test_unpackbits_inverts_packbits(width):
    x = torch.from_numpy(np.random.default_rng(width).random((3, 2, 5, width)) > 0.5)
    packed = mask_memory.packbits(x)
    np.testing.assert_array_equal(packed.numpy(), np.packbits(x.numpy(), axis=-1))
    assert torch.equal(mask_memory.unpackbits(packed, width), x)


# --- on a card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["r50_cell", "finalized_early_854_wide"])
def test_card_merge_equals_the_host_merge(merges, case):
    """The R50 cell's geometry (36 frames of 360x640, config gates); then a
    66-frame video at a 1-byte slab budget, so that a window finalizes early
    and every result is copied on its own, resized to 480x854."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the deformable attention has no CPU kernel")
    from mdqe_cvpr2023_tpu_torch.tools.profile_vis import CFG, INF as R50_INF
    model = MDQEModel(CFG, device="cuda", seed=0)
    n_frames, ori, inf = 36, (360, 640), R50_INF
    if case != "r50_cell":
        n_frames, ori = 66, (480, 854)
        inf = dataclasses.replace(inf, slab_hbm_budget=1)
    video = np.random.default_rng(5).integers(0, 255, (n_frames, 360, 640, 3)).astype(np.uint8)
    out = meta.inference_vis(model, inf, meta.preprocess_frames(video)[0], (360, 640), ori,
                             device="cuda")
    assert len(merges) == 1
    if case != "r50_cell":
        assert [w[0] for w in merges[0]["windows"]] == ["packed", "slab", "slab"]
    check_merge(out, merges[0], (n_frames,) + ori)
    req = tracing.last("vis.video")
    assert req.counters["vis.merge_results"] == len(out["pred_scores"])
    assert req.counters["vis.merge_bytes"] == len(out["pred_masks"]) * n_frames * ori[0] * ori[1]
