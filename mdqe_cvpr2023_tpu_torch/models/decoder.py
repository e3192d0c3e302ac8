"""Transformer decoder (counterpart of ``mdqe_cvpr2023_tpu/models/decoder.py``):
grid-guided query initialization, inter-frame query association, the two-level
(box / instance) deformable decoder with iterative box refinement, and the
output heads. ``forward`` is the eval path (last layer only); ``forward_train``
returns every layer's outputs and the query-init aux for the criterion, with
six dropout sites per layer drawn from a generator."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.boxes import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh
from ..utils.misc import grid_sample, interpolate_bilinear, inverse_sigmoid
from ..utils.nn import MLP, LayerNorm, Linear, MultiheadAttention, dropout
from .attention import MSDeformAttn, MSDeformAttnCfg
from .mask_head import MaskHead, MaskHeadCfg


@dataclass(frozen=True)
class DecoderCfg:
    num_classes: int = 80
    dim: int = 256
    n_heads: int = 8
    n_levels: int = 4
    n_frames: int = 1          # training clip length (weights are inflated to it)
    n_points: int = 4
    n_layers: int = 6
    mlp_ratio: float = 4.0
    n_query: int = 196
    query_embed_dim: int = 64
    window_inter_frame_asso: int = 5
    rpn_level: int = 0
    use_tca: bool = True
    mask_on: bool = True

    @property
    def n_query_bins(self) -> int:
        return int(math.sqrt(self.n_query))

    @property
    def box_attn_cfg(self) -> MSDeformAttnCfg:
        return MSDeformAttnCfg(self.dim, self.n_levels, self.n_heads, self.n_points,
                               n_frames=self.n_frames, pred_offsets=False,
                               mode="spatial")

    @property
    def inst_attn_cfg(self) -> MSDeformAttnCfg:
        return MSDeformAttnCfg(self.dim, self.n_levels, self.n_heads, self.n_points,
                               n_frames=self.n_frames, pred_offsets=False,
                               mode="temporal")

    @property
    def mask_head_cfg(self) -> MaskHeadCfg:
        return MaskHeadCfg(self.dim, (self.dim, self.dim))


def query_relpos_grid(n_bins: int, device) -> torch.Tensor:
    """(Q, Q, 2) long |grid_i - grid_j| over the n_bins x n_bins query
    lattice (x, y), made on ``device`` (nothing is uploaded)."""
    ar = torch.arange(n_bins, device=device)
    i, j = torch.meshgrid(ar, ar, indexing="ij")
    idx = torch.stack([j, i], -1).reshape(-1, 2)
    return (idx[:, None] - idx[None]).abs()


def level_slices(spatial_shapes):
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += int(h) * int(w)
    return starts, s


def encoded_to_maps(encoded, spatial_shapes):
    """(BT,N,C) -> per-level (BT,h,w,C) channel-last views."""
    starts, _ = level_slices(spatial_shapes)
    return [encoded[:, s:s + h * w].reshape(encoded.shape[0], h, w, -1)
            for s, (h, w) in zip(starts, spatial_shapes)]


def grid_guided_query_selection(cfg: DecoderCfg, rpn_cls_conf):
    """rpn_cls_conf (BT,H,W,K) logits -> (BT,Q,2) normalized xy of the per-cell
    peaks of the upsampled max class score."""
    BT, H, W, K = rpn_cls_conf.shape
    nb = cfg.n_query_bins
    max_score = torch.sigmoid(rpn_cls_conf.float()).amax(-1)          # (BT,H,W)
    H_up = (2 * H // nb + 1) * nb
    W_up = (2 * W // nb + 1) * nb
    up = interpolate_bilinear(max_score, (H_up, W_up))
    r, t = H_up // nb, W_up // nb
    cells = up.reshape(BT, nb, r, nb, t).permute(0, 1, 3, 2, 4).reshape(BT, nb, nb, r * t)
    sel = cells.argmax(-1)
    ly, lx = sel // t, sel % t
    ar = torch.arange(nb, device=sel.device)
    cy = ar[None, :, None] * r + ly
    cx = ar[None, None, :] * t + lx
    qx = cx.float() / W_up
    # Faithful to the reference: its torch.div has no rounding mode, so
    # qy = (y + x / W_up) / H_up, and the x-fraction leaks into y.
    qy = (cy.float() + qx) / H_up
    return torch.stack([qx, qy], -1).reshape(BT, nb * nb, 2)


def inter_frame_query_association(cfg: DecoderCfg, query_init, query_coords,
                                  query_embed, n_frames: int, training: bool = False):
    """Align each frame's queries to the central frame by embedding similarity
    within a relative-position window (halved at test time)."""
    BT, Q, C = query_init.shape
    if n_frames == 1:
        return query_init, query_coords
    B = BT // n_frames
    ct = (n_frames - 1) // 2
    w = cfg.window_inter_frame_asso if training else cfg.window_inter_frame_asso / 2
    emb = query_embed.reshape(B, n_frames, Q, -1)
    sim = torch.einsum("btqc,bkc->btqk", emb, emb[:, ct])
    relpos = query_relpos_grid(cfg.n_query_bins, sim.device)
    masked = []
    for t in range(n_frames):
        itv = max(t - ct, ct - t)
        mask_t = (relpos > w * itv).any(-1)                       # (Q,K)
        masked.append(sim[:, t].masked_fill(mask_t[None], float("-inf")))
    sim = torch.stack(masked, 1).reshape(BT, Q, Q)
    aligned = sim.argmax(-2)                                      # (BT,K)
    q_al = torch.gather(query_init, 1, aligned[..., None].expand(-1, -1, C))
    c_al = torch.gather(query_coords, 1, aligned[..., None].expand(-1, -1, 2))
    return q_al, c_al


def tca_frames(T: int, n_frames_train: int):
    """Frame subset used by temporal cross-attention."""
    ct = (T - 1) // 2
    itv = max(T // n_frames_train, 1)
    start = max(ct - ((n_frames_train - 1) // 2) * itv, 0)
    return list(range(start, T, itv))[:n_frames_train]


@dataclass(frozen=True)
class FrameMap:
    """Where the decoder's clips read its F distinct frames: ``rows`` (BT,)
    the frame of each clip-frame row, ``tca`` (B*n_frames,) the frame of each
    clip's temporal levels, long tensors on the device. Each site projects
    the F frames once and gathers its rows through the map."""
    rows: torch.Tensor
    tca: torch.Tensor


def own_frame_map(BT: int, T: int, n_frames_train: int, device) -> FrameMap:
    """The map of BT rows that are their own frames (clips of T frames, in
    order), made on ``device``: ``clip_frame_map(range(BT), ...)``'s rows
    and temporal levels, with nothing uploaded."""
    levels = tca_frames(T, n_frames_train)
    itv = max(T // n_frames_train, 1)
    k = torch.arange(n_frames_train, device=device)
    clip = torch.arange(0, BT, T, device=device)
    tca = clip[:, None] + (levels[0] + itv * k).clamp(max=levels[-1])
    return FrameMap(torch.arange(BT, device=device), tca.reshape(-1))


def clip_frame_map(frame_of_row, T: int, n_frames_train: int):
    """On the host, for BT clip-frame rows (clips of T frames, in order)
    naming their frames: the distinct frames ascending, each row's index
    among them, and each clip's temporal levels' (``tca_frames``, its last
    frame repeated up to ``n_frames_train``) index among them."""
    frames = sorted(set(frame_of_row))
    at = {f: i for i, f in enumerate(frames)}
    rows = [at[f] for f in frame_of_row]
    levels = tca_frames(T, n_frames_train)
    levels += levels[-1:] * (n_frames_train - len(levels))
    tca = [rows[b * T + t] for b in range(len(rows) // T) for t in levels]
    return frames, rows, tca


def clip_ref_boxes(cfg: DecoderCfg, x_ref_boxes, T: int):
    """Circumscribed clip boxes over the central n_frames window (B,Q,4)."""
    BT, Q, _ = x_ref_boxes.shape
    B = BT // T
    ct = (T - 1) // 2
    t0 = max(ct - (cfg.n_frames - 1) // 2, 0)
    t1 = ct + cfg.n_frames
    boxes = x_ref_boxes.reshape(B, T, Q, 4).transpose(1, 2)[:, :, t0:t1]
    boxes = box_cxcywh_to_xyxy(boxes).clamp(0.0, 1.0)
    circ = torch.cat([boxes[..., :2].amin(-2), boxes[..., 2:].amax(-2)], -1)
    return box_xyxy_to_cxcywh(circ)


def _init_linear(lin: Linear, gen):
    bound = 1.0 / math.sqrt(lin.in_features)
    lin.weight.uniform_(-bound, bound, generator=gen)
    lin.bias.uniform_(-bound, bound, generator=gen)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderCfg):
        super().__init__()
        d = cfg.dim
        d_ffn = int(d * cfg.mlp_ratio)
        self.cfg = cfg
        self.self_attn = MultiheadAttention(d, cfg.n_heads)
        self.norm1 = LayerNorm(d)
        self.cross_attn = MSDeformAttn(cfg.box_attn_cfg, site="decoder_box")
        self.norm2 = LayerNorm(d)
        self.linear1 = Linear(d, d_ffn)
        self.linear2 = Linear(d_ffn, d)
        self.norm3 = LayerNorm(d)
        self.time_weights = Linear(d, 1)
        self.self_attn_inst = MultiheadAttention(d, cfg.n_heads)
        self.norm1_inst = LayerNorm(d)
        self.norm2_inst = LayerNorm(d)
        self.linear1_inst = Linear(d, d_ffn)
        self.linear2_inst = Linear(d_ffn, d)
        self.norm3_inst = LayerNorm(d)
        if cfg.use_tca:
            self.temp_attn_inst = MSDeformAttn(cfg.inst_attn_cfg, site="decoder_inst")

    @torch.no_grad()
    def reset_parameters(self, gen):
        for mha in (self.self_attn, self.self_attn_inst):
            nn.init.xavier_uniform_(mha.in_proj_weight, generator=gen)
            mha.in_proj_bias.zero_()
            nn.init.xavier_uniform_(mha.out_proj.weight, generator=gen)
            mha.out_proj.bias.zero_()
        self.cross_attn.reset_parameters(gen)
        for lin in (self.linear1, self.linear2, self.time_weights,
                    self.linear1_inst, self.linear2_inst):
            _init_linear(lin, gen)
        if self.cfg.use_tca:
            self.temp_attn_inst.reset_parameters(gen)

    def ffn(self, x, suffix: str = "", drop_rate: float = 0.0, generator=None):
        lin1 = getattr(self, "linear1" + suffix)
        lin2 = getattr(self, "linear2" + suffix)
        h = dropout(F.gelu(lin1(x)), drop_rate, generator)
        x = x + dropout(lin2(h), drop_rate, generator)
        return getattr(self, "norm3" + suffix)(x)

    def forward(self, x, x_pos, x_ref_boxes, x_inst, x_inst_pos,
                x_inst_ref_boxes, src, spatial_shapes, padding_mask, T: int,
                frame_map: FrameMap, drop_rate: float = 0.0, generator=None):
        """``src`` (F,N,C) and ``padding_mask`` (F,N) are the F frames both
        sites read through ``frame_map``."""
        cfg = self.cfg
        drop = lambda t: dropout(t, drop_rate, generator)  # noqa: E731
        # box level (per frame, BT batch)
        x2 = self.cross_attn(x + x_pos, x_ref_boxes, src, spatial_shapes, padding_mask,
                             frame_map.rows)
        x = self.norm2(x + drop(x2))
        shortcut_x = x
        q = x + x_pos
        x = self.norm1(x + drop(self.self_attn(q, q, x)))
        x = self.ffn(x, "", drop_rate, generator)
        shortcut_w = x

        # instance level (per clip, B batch)
        BT, Q, C = x.shape
        B = BT // T
        tw = self.time_weights(shortcut_w.reshape(B, T, Q, C))        # (B,T,Q,1)
        sx = shortcut_x.reshape(B, T, Q, C)
        x_inst2 = (torch.softmax(tw.float(), 1).to(sx.dtype) * sx).sum(1)
        if cfg.use_tca:
            x_inst2 = self.temp_attn_inst(x_inst2 + x_inst_pos, x_inst_ref_boxes,
                                          src, spatial_shapes, padding_mask, frame_map.tca)
        x_inst = self.norm2_inst(x_inst + drop(x_inst2))
        q_inst = x_inst + x_inst_pos
        x_inst = self.norm1_inst(
            x_inst + drop(self.self_attn_inst(q_inst, q_inst, x_inst)))
        x_inst = self.ffn(x_inst, "_inst", drop_rate, generator)
        return x, x_inst


class DecoderLayers(nn.Module):
    def __init__(self, cfg: DecoderCfg):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.n_layers))


class TransformerDecoder(nn.Module):
    """Detectron2 ``transformer_dec``: decoder layers, heads and the mask head."""

    def __init__(self, cfg: DecoderCfg):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.decoder_norm = LayerNorm(d)
        self.bbox_embed = MLP(d, d, 4, 3)
        self.point2pos_proj = Linear(2, d)
        self.decoder = DecoderLayers(cfg)
        self.rpn_cls_embed = MLP(d, d, cfg.num_classes, 3)
        self.cls_embed = MLP(d, d, cfg.num_classes, 3)
        self.track_embed = MLP(d, d, cfg.query_embed_dim, 3)
        if cfg.mask_on:
            self.mask_head = MaskHead(cfg.mask_head_cfg)
            self.mask_embed = MLP(d, d, cfg.mask_head_cfg.num_gen_params, 3)

    @torch.no_grad()
    def reset_parameters(self, gen):
        """Init of ``decoder_init``: torch-default linears, focal-bias class
        heads, zero last box layer."""
        for mlp in (self.bbox_embed, self.rpn_cls_embed, self.cls_embed,
                    self.track_embed) + ((self.mask_embed,) if self.cfg.mask_on else ()):
            for lin in mlp.layers:
                _init_linear(lin, gen)
        _init_linear(self.point2pos_proj, gen)
        for layer in self.decoder.layers:
            layer.reset_parameters(gen)
        if self.cfg.mask_on:
            self.mask_head.reset_parameters(gen)
        bias_value = math.log((1 - 0.01) / 0.01)
        for head in (self.cls_embed, self.rpn_cls_embed):
            head.layers[-1].bias.fill_(-bias_value)
        self.bbox_embed.layers[-1].bias.zero_()

    def query_initialization(self, encoded, spatial_shapes, n_frames: int,
                             training: bool = False):
        """-> query (BT,Q,C), aligned query coords (BT,Q,2), and the aux the
        criterion reads: rpn_sem_cls (BT,H,W,K) logits, query_init_embed
        (BT,Q,E) before association, query_coords_grid (BT,nb,nb,2) in
        [-1, 1]."""
        cfg = self.cfg
        BT = encoded.shape[0]
        maps = encoded_to_maps(encoded, spatial_shapes)
        rpn_cls_conf = self.rpn_cls_embed(maps[cfg.rpn_level])     # (BT,H,W,K)
        query_coords = grid_guided_query_selection(cfg, rpn_cls_conf)
        nb = cfg.n_query_bins
        grid = (2.0 * query_coords - 1.0).reshape(BT, nb, nb, 2)
        feats = [grid_sample(f, grid, padding_mode="border") for f in maps]
        query_init = torch.stack(feats).mean(0).reshape(BT, cfg.n_query, -1)
        query_init_embed = self.track_embed(query_init)
        query, coords_al = inter_frame_query_association(
            cfg, query_init, query_coords, query_init_embed, n_frames, training)
        aux = {"rpn_sem_cls": rpn_cls_conf, "query_init_embed": query_init_embed,
               "query_coords_grid": grid}
        return query, coords_al, aux

    def refine(self, x, x_ref_boxes):
        """Box refinement in fp32: the refined boxes (cxcywh), the next
        layer's reference boxes (the same, with no gradient, as the JAX
        package's stop_gradient) and the positional projection in x's type."""
        off = self.bbox_embed(self.decoder_norm(x)).float()
        boxes = torch.sigmoid(off + inverse_sigmoid(x_ref_boxes))
        return boxes, boxes.detach(), self.point2pos_proj(boxes[..., :2]).to(x.dtype)

    def decoder_loop(self, x, x_ref_points, src, spatial_shapes, padding_mask,
                     T: int, frame_map: FrameMap, drop_rate: float = 0.0, generator=None):
        """-> lists of the instance queries (B,Q,C) and refined boxes (BT,Q,4)
        cxcywh after the warm-up refinement and each layer (L+1 entries).
        ``src`` and ``padding_mask`` hold ``frame_map``'s F frames."""
        cfg = self.cfg
        BT, Q, C = x.shape
        B = BT // T
        ct = (T - 1) // 2
        x_ref_boxes = torch.cat([x_ref_points, torch.full_like(x_ref_points, 0.1)], -1)
        x_inst = x.reshape(B, T, Q, C)[:, ct]
        x_boxes, x_ref_boxes, x_pos = self.refine(x, x_ref_boxes)
        x_inst_ref = clip_ref_boxes(cfg, x_ref_boxes, T)
        x_inst_pos = self.point2pos_proj(x_inst_ref[..., :2]).to(x.dtype)
        insts, boxes = [x_inst], [x_boxes]
        for layer in self.decoder.layers:
            x, x_inst = layer(x, x_pos, x_ref_boxes, x_inst, x_inst_pos, x_inst_ref,
                              src, spatial_shapes, padding_mask, T, frame_map, drop_rate,
                              generator)
            x_boxes, x_ref_boxes, x_pos = self.refine(x, x_ref_boxes)
            x_inst_ref = clip_ref_boxes(cfg, x_ref_boxes, T)
            x_inst_pos = self.point2pos_proj(x_inst_ref[..., :2]).to(x.dtype)
            insts.append(x_inst)
            boxes.append(x_boxes)
        return insts, boxes

    def decode(self, src, padding_mask, spatial_shapes, T: int, frame_map: FrameMap,
               training: bool, drop_rate: float = 0.0, generator=None):
        """Both entry points' body: src (F,N,C) and padding_mask (F,N) the F
        frames ``frame_map`` names. -> the clips' rows (BT,N,C), the query
        coords and aux of ``query_initialization``, ``decoder_loop``'s lists."""
        encoded = src.index_select(0, frame_map.rows)
        query, query_coords, aux = self.query_initialization(encoded, spatial_shapes, T,
                                                             training)
        insts, boxes = self.decoder_loop(query, query_coords, src, spatial_shapes,
                                         padding_mask, T, frame_map, drop_rate, generator)
        return encoded, query_coords, aux, insts, boxes

    def forward_train(self, encoded, padding_mask, spatial_shapes, n_frames: int,
                      drop_rate: float = 0.0, generator=None):
        """``decoder_apply(training=True)``: every layer's outputs, the rows
        of encoded (BT,N,C) their own frames (``own_frame_map``). Returns
        {'cls' (L+1,B,Q,K) logits, 'boxes' (L+1,B,Q,T,4) xyxy, 'mask_coeff'
        (L+1,B,Q,M), 'proto' (BT,h4,w4,M), 'query_init' (aux of
        ``query_initialization``), 'query_coords' (BT,Q,2)}."""
        T = n_frames
        frame_map = own_frame_map(encoded.shape[0], T, self.cfg.n_frames, encoded.device)
        encoded, query_coords, aux, insts, boxes = self.decode(
            encoded, padding_mask, spatial_shapes, T, frame_map, True, drop_rate, generator)
        inter_inst, inter_boxes = torch.stack(insts), torch.stack(boxes)
        L1, BT, Q, _ = inter_boxes.shape
        boxes = inter_boxes.reshape(L1, BT // T, T, Q, 4).transpose(2, 3)
        normed = self.decoder_norm(inter_inst)
        maps = encoded_to_maps(encoded, spatial_shapes)
        return {"cls": self.cls_embed(normed),
                "boxes": box_cxcywh_to_xyxy(boxes),
                "mask_coeff": torch.tanh(self.mask_embed(normed)),
                "proto": self.mask_head(maps[2], [maps[1], maps[0]]),
                "query_init": aux,
                "query_coords": query_coords}

    def forward(self, encoded, padding_mask, spatial_shapes, n_frames: int,
                is_coco: bool = False, frame_map=None):
        """Eval ``decoder_apply(training=False, is_coco=...)``. encoded
        (F,N,C), padding_mask (F,N) True on padded: the F frames the BT rows
        of ``frame_map`` name, each projected once (without a map, the rows
        are their own frames: ``own_frame_map``). Returns {'cls' (B,Q,K)
        sigmoid} and, for the VIS path, {'mask_coeff' (B,Q,M), 'query_embed'
        (B,Q,C)}; with ``is_coco``, {'masks' (B,Q,BT,h4,w4) mask logits of
        every frame, 'boxes' (B,Q,T,4) xyxy of the last layer}."""
        T = n_frames
        if frame_map is None:
            frame_map = own_frame_map(encoded.shape[0], T, self.cfg.n_frames, encoded.device)
        encoded, _, _, insts, boxes = self.decode(encoded, padding_mask, spatial_shapes, T,
                                                  frame_map, False)
        x_inst = insts[-1]
        last = self.decoder_norm(x_inst)
        out = {"cls": torch.sigmoid(self.cls_embed(last))}
        coeff = torch.tanh(self.mask_embed(last))
        if not is_coco:
            out["mask_coeff"] = coeff
            out["query_embed"] = x_inst
            return out
        maps = encoded_to_maps(encoded, spatial_shapes)
        proto = self.mask_head(maps[2], [maps[1], maps[0]])          # (BT,h4,w4,M)
        out["masks"] = torch.einsum("bqm,thwm->bqthw", coeff, proto)
        BT, Q, _ = boxes[-1].shape
        out["boxes"] = box_cxcywh_to_xyxy(boxes[-1].reshape(BT // T, T, Q, 4).transpose(1, 2))
        return out
