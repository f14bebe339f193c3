"""The work of the network at a cell's shapes, counted from the
configuration file alone, in plain Python: the conv FLOP of each module
(2 x output elements x taps x Cin, a transposed conv counted as the
input-dilated conv whose output it has), the train step's FLOP, and the
bytes each level group must move.

The count is the network's algebra: every conv of every block once, the
logit head's residual conv apart from its conv, whatever routes, folds or
kernels the program takes. It leaves BatchNorm, PReLU, the gates and the
blend out, so a share of the peak from it is slightly low.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# bytes of an element in the named dtype
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _dhw(v: Sequence[int]) -> Tuple[int, int, int]:
    """(H, W, D) -> (D, H, W)."""
    return (int(v[2]), int(v[0]), int(v[1]))


def level_sizes(cfg: dict, window: Sequence[int]) -> List[Tuple[int, ...]]:
    """The (D, H, W) size at each level 0 .. n (the bottom) of a window
    (H, W, D)."""
    size = np.asarray(_dhw(window))
    out = [tuple(int(v) for v in size)]
    for s in cfg["strides"]:
        size = size // np.asarray(_dhw(s))
        out.append(tuple(int(v) for v in size))
    return out


def conv_modules(cfg: dict, window: Sequence[int], batch: int = 1):
    """[(module path, level, FLOP, Cin, Cout, taps, reads the input
    image)] of every conv of one forward over `batch` windows, in forward
    order. `level` is the level whose time the module's launch counts to
    (n for the bottom)."""
    ch = [int(c) for c in cfg["channels"]]
    ks = [tuple(k) for k in cfg["kernel_sizes"]]
    sks = [tuple(k) for k in cfg["sample_kernel_sizes"]]
    n = len(cfg["strides"])
    att = bool(cfg["attention"])
    out_ch = int(cfg["out_channels"])
    sizes = level_sizes(cfg, window)
    vox = [batch * int(np.prod(s)) for s in sizes]
    mods = []

    def add(path, lv, out_vox, cin, cout, k, image=False):
        taps = int(np.prod(k))
        mods.append((path, lv, 2 * out_vox * cout * taps * cin, cin, cout,
                     taps, image))

    cin = int(cfg["in_channels"])
    for i in range(n):
        for su in range(int(cfg["num_res_units"])):
            add(f"down_{i}.unit{su}.conv", i, vox[i], cin if su == 0
                else ch[i], ch[i], ks[i], image=(i == 0 and su == 0))
        add(f"down_{i}.residual", i, vox[i], cin, ch[i], (1, 1, 1),
            image=(i == 0))
        add(f"downsample_{i}.conv", i, vox[i + 1], ch[i], ch[i], sks[i])
        cin = ch[i]
    if att:
        c = ch[n - 1]
        add("bottom_att.conv1.conv", n, vox[n], c, c // 2, ks[n])
        add("bottom_att.conv2.conv", n, vox[n], c // 2, 1, ks[n])
    for su in range(int(cfg["num_res_units"])):
        add(f"bottom.unit{su}.conv", n, vox[n], ch[n - 1] if su == 0
            else ch[n], ch[n], ks[n])
    add("bottom.residual", n, vox[n], ch[n - 1], ch[n], (1, 1, 1))
    for i in reversed(range(n)):
        add(f"upsample_{i}.conv", i, vox[i], ch[i + 1], ch[i], sks[i])
        if att:
            add(f"upatt_{i}.conv1.conv", i, vox[i], 2 * ch[i], ch[i], ks[i])
            add(f"upatt_{i}.conv2.conv", i, vox[i], ch[i], 1, ks[i])
        outc = out_ch if i == 0 else ch[i]
        add(f"up_{i}.unit0.conv", i, vox[i], 2 * ch[i], outc, ks[i])
        add(f"up_{i}.residual", i, vox[i], 2 * ch[i], outc, (1, 1, 1))
    return mods


def forward_flops(cfg: dict, window: Sequence[int], batch: int = 1) -> int:
    """Conv FLOP of one forward over `batch` windows."""
    return sum(m[2] for m in conv_modules(cfg, window, batch))


def train_step_flops(cfg: dict, crop: Sequence[int], batch: int = 1) -> int:
    """Conv FLOP of one train step: each conv's forward, its weight
    gradient and its input gradient (none into the input image: the
    convs that read it need no data gradient)."""
    return sum(f * (2 if image else 3)
               for _, _, f, _, _, _, image in conv_modules(cfg, crop, batch))


def group_work(cfg: dict, window: Sequence[int], batch: int,
               levels: Sequence[int]) -> Dict[str, int]:
    """FLOP and bytes of the level group `levels` (n stands for the
    bottom) of one eval forward over `batch` windows. Bytes: every tensor
    that crosses the group's boundary, read or written once in the
    compute dtype (the input image and the logits in theirs), the
    attention maps the group writes, and its modules' float32 weights
    and biases."""
    n = len(cfg["strides"])
    ch = [int(c) for c in cfg["channels"]]
    act = DTYPE_BYTES[cfg["compute_dtype"]]
    sizes = level_sizes(cfg, window)
    vox = [batch * int(np.prod(s)) for s in sizes]
    group = set(int(v) for v in levels)
    flop = weights = 0
    for _, lv, f, cin, cout, taps, _ in conv_modules(cfg, window, batch):
        if lv in group:
            flop += f
            weights += 4 * (taps * cin * cout + cout)
    moved = weights
    lo = min(group)
    if lo == 0:
        moved += vox[0] * int(cfg["in_channels"]) * act      # the image
        moved += vox[0] * int(cfg["out_channels"]) * act     # the logits
    else:
        moved += vox[lo] * ch[lo - 1] * act     # from downsample_{lo-1}
        moved += vox[lo] * ch[lo] * act         # up_lo's output, upward
    hi = max(group)
    if hi < n:
        moved += vox[hi + 1] * ch[hi] * act     # downsample_hi's output
        moved += vox[hi + 1] * ch[hi + 1] * act  # the input of upsample_hi
    if cfg["attention"]:
        moved += sum(vox[lv] * act for lv in group)          # the maps
    return {"flop": flop, "bytes": moved}
