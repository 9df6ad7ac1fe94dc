"""Model FLOPs of one image, counted from the configuration's shapes: every
matrix product (a multiply-add counts two), forward and backward as run
(the backward two forwards of each trained product, no recomputation), no
elementwise work. The yardstick of the ``mfu`` metrics: it reads nothing of
the program.

Widths not in a configuration file are the architecture's: the ViT
variants below, the SegHead (128 and 64 channels per tap, two 4x4
transposed convolutions to 128, a 3x3 classifier), the DINO head (2048
hidden, 256 bottleneck), the MLP encoder (512), 26 character slots, 32x128
images.
"""

from __future__ import annotations

ARCHS = {"vit_micro": (64, 3, 2), "vit_tiny": (192, 12, 3), "vit_small": (384, 12, 6),
         "vit_base": (512, 12, 8)}                 # (width, depth, heads)
IMAGE = (32, 128)
SLOTS = 26
ENCODER_WIDTH = 512
HEAD_HIDDEN, HEAD_BOTTLENECK = 2048, 256
SEG_MLA, SEG_MLAHEAD, SEG_UNPOOL, SEG_CLASSES = 128, 64, 128, 2
TRAIN = 3  # forward + backward (inputs and weights)


def grid(patch: int):
    return IMAGE[0] // patch, IMAGE[1] // patch


def vit(arch: str, patch: int) -> float:
    """The ViT forward: patch embedding, then per block qkv, the two
    attention products, the projection and the MLP (ratio 4)."""
    c, depth, _ = ARCHS[arch]
    gh, gw = grid(patch)
    n = gh * gw
    block = 2 * n * c * 3 * c + 2 * 2 * n * n * c + 2 * n * c * c + 2 * 2 * n * c * 4 * c
    return 2 * n * patch * patch * 3 * c + depth * block


def seg_head(arch: str, patch: int) -> float:
    c = ARCHS[arch][0]
    gh, gw = grid(patch)
    px = gh * gw
    branches = 3 * (2 * px * c * SEG_MLA * 9 + 2 * px * SEG_MLA * SEG_MLAHEAD)
    unpool1 = 2 * px * 3 * SEG_MLAHEAD * SEG_UNPOOL * 16
    unpool2 = 2 * (4 * px) * SEG_UNPOOL * SEG_UNPOOL * 16
    classify = 2 * (16 * px) * SEG_UNPOOL * SEG_CLASSES * 9
    return branches + unpool1 + unpool2 + classify


def pool_and_head(arch: str, patch: int, out_dim: int) -> float:
    """Character pooling and the DINO head over every slot of one view."""
    c = ARCHS[arch][0]
    gh, gw = grid(patch)
    pool = 2 * SLOTS * gh * gw * c
    row = 2 * (c * HEAD_HIDDEN + HEAD_HIDDEN * HEAD_HIDDEN + HEAD_HIDDEN * HEAD_BOTTLENECK
               + HEAD_BOTTLENECK * out_dim)
    return pool + SLOTS * row


def pretrain_image(cfg: dict) -> float:
    """Two views of an image: the student trained on both (ViT, SegHead,
    pooling and head), the teacher's forward on both."""
    arch, patch = cfg["arch"], cfg["patch_size"]
    view = vit(arch, patch) + pool_and_head(arch, patch, cfg["out_dim"])
    return 2 * (TRAIN * (view + seg_head(arch, patch)) + view)


def encoder(arch: str, patch: int) -> float:
    gh, gw = grid(patch)
    return 2 * gh * gw * (ARCHS[arch][0] * ENCODER_WIDTH + ENCODER_WIDTH * ENCODER_WIDTH)


def decoder_teacher_forced(d: dict, classes: int, tokens: int) -> float:
    """The NRTR decoder over ``d['max_seq_len']`` positions at once."""
    t, m, s = d["max_seq_len"], d["d_model"], tokens
    hk, hv = d["n_head"] * d["d_k"], d["n_head"] * d["d_v"]
    self_attn = 2 * t * m * (2 * hk + hv) + 2 * t * t * (hk + hv) + 2 * t * hv * m
    cross = 2 * t * m * hk + 2 * s * ENCODER_WIDTH * (hk + hv) + 2 * t * s * (hk + hv) \
        + 2 * t * hv * m
    ffn = 2 * 2 * t * m * d["d_inner"]
    return d["n_layers"] * (self_attn + cross + ffn) + 2 * t * m * classes


def decoder_greedy(d: dict, classes: int, tokens: int) -> float:
    """The KV-cached greedy decode: the encoder's keys and values once, then
    ``max_seq_len`` steps of one position each, attending over the whole
    cache (max_seq_len + 1 positions, the later ones masked) as it runs."""
    t, m, s = d["max_seq_len"], d["d_model"], tokens
    hk, hv = d["n_head"] * d["d_k"], d["n_head"] * d["d_v"]
    cache = t + 1
    step = (2 * m * (2 * hk + hv) + 2 * cache * (hk + hv) + 2 * hv * m      # self
            + 2 * m * hk + 2 * s * (hk + hv) + 2 * hv * m                    # cross
            + 2 * 2 * m * d["d_inner"])                                      # ffn
    kv = 2 * s * ENCODER_WIDTH * (hk + hv)
    return d["n_layers"] * (kv + t * step) + t * 2 * m * classes


def recognizer_classes(cfg: dict) -> int:
    """The classifier's outputs: the character set, unknown and the shared
    start/end id (the padding id has no output)."""
    return cfg["decoder"]["num_classes"] - 1


def finetune_image(cfg: dict) -> float:
    arch, patch = cfg["arch"], cfg["patch_size"]
    gh, gw = grid(patch)
    return TRAIN * (vit(arch, patch) + encoder(arch, patch)
                    + decoder_teacher_forced(cfg["decoder"], recognizer_classes(cfg), gh * gw))


def eval_image(cfg: dict) -> float:
    arch, patch = cfg["arch"], cfg["patch_size"]
    gh, gw = grid(patch)
    return vit(arch, patch) + encoder(arch, patch) \
        + decoder_greedy(cfg["decoder"], recognizer_classes(cfg), gh * gw)


PER_IMAGE = {"pretrain": pretrain_image, "finetune": finetune_image, "eval": eval_image}
