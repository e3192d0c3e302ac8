"""Model FLOPs of the benchmark's cells, worked out from the configuration
file and the input shapes alone (nothing of the port is read), for ``mfu``.

Counted: every matrix product and convolution of the network (2 FLOPs a
multiply-add, as ``torch.utils.flop_counter`` counts them) and, by hand, the
deformable attention's bilinear sampling (4 corners x 2 FLOPs a channel for
each sampling point). Frames and clips are the real ones (no padded frame
of a tail window, no padded clip of a decode batch); a frame is counted at
its padded size (the size the network runs at). VIS: the encode
(backbone, input projections, encoder) in bf16 under ``bf16_encode``, the
mask head, decoder, heads and the clip post-processing's products in fp32;
the tracker's matching products and Swin v2's position-bias MLP (run once a
call on a constant table, not a frame's work) are left out. Training: the forward, and
the backward as two more forwards of every product that takes a gradient
(one more where only one operand does; none for the frozen ResNet stem and
res2, whose input needs no gradient), all fp32; the matcher's products once.
"""
from __future__ import annotations

import math


def _lin(n, cin, cout):
    return 2.0 * n * cin * cout


def _conv(cin, cout, k, ho, wo, groups=1):
    return 2.0 * ho * wo * cout * (cin // groups) * k * k


def _out(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def _mlp(n, d, out, layers=3):
    dims = [d] * layers + [out]
    return sum(_lin(n, dims[i], dims[i + 1]) for i in range(layers))


def resnet(depth: int, H: int, W: int):
    """(FLOPs of the stem and res2, of res3-res5, [(channels, h, w)] of
    res3-res5) for one frame of H x W."""
    stages = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}[depth]
    h, w = _out(H, 7, 2, 3), _out(W, 7, 2, 3)
    frozen, rest = _conv(3, 64, 7, h, w), 0.0
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, feats = 64, []
    for si, nb in enumerate(stages):
        b = 64 * 2 ** si
        cout = 4 * b
        f = 0.0
        for bi in range(nb):
            s = 2 if bi == 0 and si > 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            f += _conv(cin, b, 1, h, w) + _conv(b, b, 3, ho, wo) + _conv(b, cout, 1, ho, wo)
            if cin != cout or s != 1:
                f += _conv(cin, cout, 1, ho, wo)
            h, w, cin = ho, wo, cout
        if si == 0:
            frozen += f
        else:
            rest += f
            feats.append((cout, h, w))
    return frozen, rest, feats


def swin(sw: dict, H: int, W: int):
    """(0, FLOPs, [(channels, h, w)] of the emitted stages) for one frame."""
    C, ps = sw["embed_dim"], sw["patch_size"]
    h, w = -(-H // ps), -(-W // ps)
    f = _conv(3, C, ps, h, w)
    depths = sw["depths"]
    feats = []
    for i, depth in enumerate(depths):
        Ci = C * 2 ** i
        win = sw["window_size"] // 2 if sw["version"] == 2 and i == len(depths) - 1 \
            else sw["window_size"]
        n_pad = -(-h // win) * win * (-(-w // win) * win)
        hidden = int(Ci * sw["mlp_ratio"])
        blk = (_lin(n_pad, Ci, 3 * Ci) + 4.0 * n_pad * win * win * Ci + _lin(n_pad, Ci, Ci)
               + _lin(h * w, Ci, hidden) + _lin(h * w, hidden, Ci))
        f += depth * blk
        if i in sw["out_stages"]:
            feats.append((Ci, h, w))
        if i < len(depths) - 1:
            h, w = -(-h // 2), -(-w // 2)
            f += _lin(h * w, 4 * Ci, 2 * Ci)
    return 0.0, f, feats


def _levels(model: dict, Hp: int, Wp: int):
    """The pyramid levels' (h, w): ceil of the padded size over each level's
    stride (the backbone's, then twice the one before)."""
    strides = [4 * 2 ** i for i in model["swin"]["out_stages"]] if "swin" in model \
        else [8, 16, 32]
    strides = strides[:model["n_feature_levels"]]
    while len(strides) < model["n_feature_levels"]:
        strides.append(strides[-1] * 2)
    return [(-(-Hp // s), -(-Wp // s)) for s in strides]


def encode_frame(model: dict, Hp: int, Wp: int):
    """(frozen backbone FLOPs, the rest of the encode's FLOPs) of one frame:
    backbone, input projections, deformable encoder (its sampling by hand)."""
    if "swin" in model:
        frozen, bb, feats = swin(model["swin"], Hp, Wp)
    else:
        frozen, bb, feats = resnet(int(model["backbone"][len("resnet"):]), Hp, Wp)
    d, L = model["hidden_dim"], model["n_feature_levels"]
    levels = _levels(model, Hp, Wp)
    proj = 0.0
    for i, (h, w) in enumerate(levels):
        if i < len(feats):
            proj += _conv(feats[i][0], d, 1, h, w)
        else:
            proj += _conv(feats[-1][0] if i == len(feats) else d, d, 3, h, w)
    N = sum(h * w for h, w in levels)
    H, P = model["n_heads"], model["enc_points"]
    ffn = int(d * model["mlp_ratio"])
    layer = (2 * _lin(N, d, d) + _lin(N, d, H * L * P * 2) + _lin(N, d, H * L * P)
             + _lin(N, d, ffn) + _lin(N, ffn, d) + 8.0 * N * H * L * P * (d // H))
    return frozen, bb + proj + model["enc_layers"] * layer


def mask_head_frame(model: dict, Hp: int, Wp: int):
    d = model["hidden_dim"]
    (h0, w0), (h1, w1), (h2, w2) = _levels(model, Hp, Wp)[:3]
    M = d // 8
    return (_conv(d, d, 3, h2, w2) + _conv(d, d, 1, h1, w1) + _conv(d, d, 3, h1, w1)
            + _conv(d, d, 1, h0, w0) + _conv(d, d, 3, h0, w0)
            + _conv(d, d, 5, h0, w0, groups=d) + _conv(d, d, 1, h0, w0)
            + _conv(d, d, 5, 2 * h0, 2 * w0, groups=d) + _conv(d, M, 1, 2 * h0, 2 * w0))


def decoder_clip(model: dict, T: int, Hp: int, Wp: int, training: bool = False):
    """FLOPs of the decoder on one clip of T frames: query initialization,
    the layers (their sampling by hand) and the refinements; the heads on
    the last layer (every layer in training)."""
    d, K, Q, E = model["hidden_dim"], model["num_classes"], model["n_query"], \
        model["query_embed_dim"]
    H, P, L, nl = model["n_heads"], model["dec_points"], model["n_feature_levels"], \
        model["dec_layers"]
    nf = model["n_frames"]
    M = d // 8
    levels = _levels(model, Hp, Wp)
    N = sum(h * w for h, w in levels)
    h0, w0 = levels[0]
    D, ffn = d // H, int(d * model["mlp_ratio"])
    TQ = T * Q
    f = T * h0 * w0 * (2.0 * d * d * 2 + 2.0 * d * K) + _mlp(TQ, d, E)
    if T > 1:
        f += 2.0 * T * Q * Q * E
    refine = _mlp(TQ, d, 4) + _lin(TQ, 2, d) + _lin(Q, 2, d)
    layer = (_lin(T * N, d, d) + _lin(TQ, d, H * L * P * 2) + _lin(TQ, d, H * L * P)
             + _lin(TQ, d, d) + 8.0 * TQ * H * L * P * D
             + _lin(TQ, d, 3 * d) + 4.0 * T * Q * Q * d + _lin(TQ, d, d)
             + _lin(TQ, d, ffn) + _lin(TQ, ffn, d) + _lin(TQ, d, 1))
    if model["dec_temporal"]:
        layer += (_lin(nf * N, d, d) + _lin(Q, d, H * nf * P * 2) + _lin(Q, d, H * nf * P)
                  + _lin(Q, d, d) + 8.0 * L * Q * H * nf * P * D)
    layer += _lin(Q, d, 3 * d) + 4.0 * Q * Q * d + _lin(Q, d, d) + _lin(Q, d, ffn) \
        + _lin(Q, ffn, d)
    heads = _mlp(Q, d, K) + _mlp(Q, d, M)
    return f + (nl + 1) * refine + nl * layer + (nl + 1 if training else 1) * heads


def postprocess_clip(model: dict, T: int, Hp: int, Wp: int):
    """The clip post-processing's products: query similarity, the masks
    (queries x proto features) and the soft-mask NMS."""
    d, Q = model["hidden_dim"], model["n_query"]
    h4, w4 = 2 * _levels(model, Hp, Wp)[0][0], 2 * _levels(model, Hp, Wp)[0][1]
    Tn = -(-T // 2) if T >= 5 else T
    return (2.0 * Q * Q * d + 2.0 * Q * (d // 8) * T * h4 * w4
            + 2.0 * Q * Q * Tn * (-(-h4 // 2)) * (-(-w4 // 2)))


def vis_video(cfg: dict, inf, frames: int, padded_hw) -> dict:
    """{precision: FLOPs} of one video of ``frames`` frames at the padded
    size ``padded_hw`` through ``inference_vis``."""
    model = cfg["model"]
    Hp, Wp = padded_hw
    T, stride = inf.n_frames_test, inf.clip_stride
    clips = 0
    for start in range(0, max(frames, T), stride):
        clips += 1
        if start + T >= max(frames, T):
            break
    frozen, enc = encode_frame(model, Hp, Wp)
    enc_prec = "bf16" if cfg["inference"].get("bf16_encode", True) else "fp32"
    fp32 = frames * mask_head_frame(model, Hp, Wp) \
        + clips * (decoder_clip(model, T, Hp, Wp) + postprocess_clip(model, T, Hp, Wp))
    out = {"fp32": fp32}
    out[enc_prec] = out.get(enc_prec, 0.0) + frames * (frozen + enc)
    return out


def criterion(cfg: dict, clips: int, T: int, Hp: int, Wp: int):
    """The criterion's products of one step, forward only: (the mask
    logits, queries x proto features; the BCE and dice pair products, whose
    one operand takes a gradient; the matcher's and the targets' products)."""
    model = cfg["model"]
    d, Q, N = model["hidden_dim"], model["n_query"], cfg["train"]["slots"]
    lv = _levels(model, Hp, Wp)[0]
    P = T * 4 * lv[0] * lv[1]
    layers = model["dec_layers"] + 1
    pair = 2.0 * clips * Q * N * P
    return (layers * 2.0 * clips * Q * (d // 8) * P, layers * 4 * pair,
            layers * (3 * pair + 2.0 * clips * N * N * P))


def train_forward(cfg: dict, padded_hw):
    """The forward of one training step of ``IMS_PER_BATCH`` clips at the
    padded size ``padded_hw``: (frozen backbone, the rest of the network,
    the criterion's three parts as ``criterion`` returns them)."""
    model = cfg["model"]
    Hp, Wp = padded_hw
    clips, T = int(cfg["IMS_PER_BATCH"]), int(cfg["train"]["n_frames"])
    frozen, enc = encode_frame(model, Hp, Wp)
    net = clips * T * (enc + mask_head_frame(model, Hp, Wp)) \
        + clips * decoder_clip(model, T, Hp, Wp, training=True)
    return (clips * T * frozen, net) + criterion(cfg, clips, T, Hp, Wp)


def train_step(cfg: dict, padded_hw) -> dict:
    """{"fp32": FLOPs} of one training step (forward and backward)."""
    frozen, net, masks, pairs, nograd = train_forward(cfg, padded_hw)
    return {"fp32": frozen + 3.0 * (net + masks) + 2.0 * pairs + nograd}


def frames_padded(size, divisibility: int = 32):
    return tuple(int(math.ceil(s / divisibility) * divisibility) for s in size)
