"""Plain reference of ``ocr_craftgn_crnn97`` and the judge of its answers.

Written from the architectures' descriptions (CRAFT, Baek et al., CVPR
2019, on a VGG16 backbone with GroupNorm; EasyOCR's english_g2 CRNN, VGG
convolutions of 32 to 256 with GroupNorm, two BiLSTMs of 256 and a 97-class
CTC head), in plain PyTorch and NumPy on the ``.npz`` weights read with
NumPy. It imports nothing of the program and takes nothing the program
made: it letterboxes each photo onto its canvas again, computes the
detector's maps, warps every crop from the photo again and computes the
recognizer's logits. The program's answers (quads and texts) are what it
judges:

- detection (``judge_detection``): the reference's text peaks (pieces of
  its thresholded maps that pass ``text_threshold``) that no returned quad
  covers, and the returned quads that lie on nothing, counted against all
  peaks and all quads;
- recognition (``read_gaps``): for each returned text, the gap between its
  returned confidence and the confidence of the reference's most probable
  CTC alignment of the same text, in log probability per character. A text
  the reference reads otherwise, or one altered after it was read, shows
  as the log probability the reference gives its labels;
- recognition (``texts_differ``): each returned text held to the
  reference's own greedy read of the same crop (either read where the
  contrast re-read runs). A character dropped with its confidence
  recomputed leaves the gap near 0, not this.

Every product takes its operands through ``q`` (``portbench/core/lowp.py``):
float32 as it is for the reference, float8 for the control. Deviations from
the program, which the judge's limits absorb: the canvas is a float
bilinear resize (cv2's is 11-bit fixed point), the crop warp is float
bilinear with the sample point as OpenCV's float path computes it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
GN_EPS = 1e-6
CROP_H = 32
FLOOR = 1e-38  # confidences below this compare as this


# ----------------------------------------------------------------------
# Weights
# ----------------------------------------------------------------------


def load_params(path: str, device) -> Dict[str, torch.Tensor]:
    """A flax ``.npz`` -> {"a/b/kernel": float32 tensor} (the "params/" prefix dropped)."""
    with np.load(path) as z:
        return {k.split("/", 1)[1]: torch.from_numpy(np.asarray(z[k], np.float32)).to(device) for k in z.files}


def _conv(x, p, name, q: Q, padding=0, dilation=1, bias=True):
    w = p[name + "/kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(q(x), q(w), padding=padding, dilation=dilation)
    if bias:
        y = y + p[name + "/bias"][:, None, None]
    return y


def _gn(x, p, name, groups=32):
    c = x.shape[1]
    return F.group_norm(x, min(groups, c), p[name + "/scale"], p[name + "/bias"], GN_EPS)


def _linear(x, p, name, q: Q):
    return torch.matmul(q(x), q(p[name + "/kernel"])) + p[name + "/bias"]


# ----------------------------------------------------------------------
# CRAFT
# ----------------------------------------------------------------------

def _conv_gn_relu(x, p, name, q, k=3):
    return F.relu(_gn(_conv(x, p, name + "/Conv_0", q, padding=k // 2, bias=False), p, name + "/GroupNorm_0"))


def craft_maps(p, canvas: torch.Tensor, q: Q) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) gray canvas in [0, 255] -> region, affinity (B, H/2, W/2)
    sigmoid scores, float32. The gray plane goes to RGB, /255 and ImageNet
    normalisation; 'SAME' convolutions pad with zeros."""
    x = canvas.float()[:, None].expand(-1, 3, -1, -1) / 255.0
    mean = torch.tensor(MEAN, device=x.device)[:, None, None]
    std = torch.tensor(STD, device=x.device)[:, None, None]
    x = (x - mean) / std
    feats = []  # 128 @ /2, 256 @ /4, 512 @ /8
    for i in range(13):
        x = _conv_gn_relu(x, p, f"VGG16BN_0/ConvBN_{i}", q)
        if i in (3, 6, 9):
            feats.append(x)
        if i in (1, 3, 6, 9):
            x = F.max_pool2d(x, 2)
    f4 = x  # 512 @ /16
    x = F.max_pool2d(x, 3, stride=1, padding=1)
    x = F.relu(_conv(x, p, "VGG16BN_0/ConvBN_13/Conv_0", q, padding=6, dilation=6))
    f5 = F.relu(_conv(x, p, "VGG16BN_0/ConvBN_14/Conv_0", q))
    y = torch.cat([f5, f4], 1)
    skips = feats[::-1]  # f3, f2, f1
    for d in range(4):
        y = _conv_gn_relu(y, p, f"DoubleConv_{d}/ConvBN_0", q, k=1)
        y = _conv_gn_relu(y, p, f"DoubleConv_{d}/ConvBN_1", q, k=3)
        if d < 3:
            s = skips[d]
            y = torch.cat([F.interpolate(y, size=s.shape[-2:], mode="bilinear", align_corners=False), s], 1)
    for i, k in enumerate((3, 3, 3, 1)):
        y = F.relu(_conv(y, p, f"ConvBN_{i}/Conv_0", q, padding=k // 2))
    out = torch.sigmoid(_conv(y, p, "Conv_0", q))
    return out[:, 0], out[:, 1]


# ----------------------------------------------------------------------
# CRNN
# ----------------------------------------------------------------------


def _lstm(x, p, name, q: Q, reverse: bool):
    """One direction over the whole (padded) sequence: gates i, f, g, o;
    one bias."""
    b, t, _ = x.shape
    w_ih, b_ih, w_hh = p[name + "/w_ih"], p[name + "/b_ih"], p[name + "/w_hh"]
    hidden = w_hh.shape[0]
    xz = torch.matmul(q(x), q(w_ih)) + b_ih
    h = x.new_zeros(b, hidden)
    c = x.new_zeros(b, hidden)
    out = [None] * t
    steps = range(t - 1, -1, -1) if reverse else range(t)
    qw_hh = q(w_hh)
    for s in steps:
        z = xz[:, s] + torch.matmul(q(h), qw_hh)
        i, f, g, o = z.split(hidden, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[s] = h
    return torch.stack(out, 1)


def crnn_logits(p, crops: torch.Tensor, q: Q) -> torch.Tensor:
    """(N, 32, W) crops in [0, 255] -> (N, W/4 - 1, classes) logits."""
    x = (crops.float() / 127.5 - 1.0)[:, None]
    v = "VGGFeatures_0/"
    x = F.max_pool2d(F.relu(_conv(x, p, v + "Conv_0", q, padding=1)), 2)
    x = F.max_pool2d(F.relu(_conv(x, p, v + "Conv_1", q, padding=1)), 2)
    x = F.relu(_conv(F.relu(_conv(x, p, v + "Conv_2", q, padding=1)), p, v + "Conv_3", q, padding=1))
    x = F.max_pool2d(x, (2, 1))
    x = F.relu(_gn(_conv(x, p, v + "Conv_4", q, padding=1, bias=False), p, v + "GroupNorm_0"))
    x = F.relu(_gn(_conv(x, p, v + "Conv_5", q, padding=1, bias=False), p, v + "GroupNorm_1"))
    x = F.max_pool2d(x, (2, 1))
    x = F.relu(_conv(x, p, v + "Conv_6", q))
    seq = x[:, :, 0, :].transpose(1, 2)
    for r in ("rnn0", "rnn1"):
        both = torch.cat([_lstm(seq, p, r + "/fwd", q, False), _lstm(seq, p, r + "/bwd", q, True)], -1)
        seq = _linear(both, p, r + "/proj", q)
    return _linear(seq, p, "head", q)


# ----------------------------------------------------------------------
# Shapes: frozen copies of the engine's bucketing rules
# ----------------------------------------------------------------------


def pick_canvas(h: int, w: int, canvases: Sequence[Tuple[int, int]], detail: float) -> Tuple[int, int]:
    """Among canvases keeping the letterbox scale >= ``detail``, the best
    aspect match in 0.08-wide bins, ties to the smaller; else the one that
    keeps the most detail."""
    aspect = w / max(h, 1)

    def fit(c):
        return min(c[0] / h, c[1] / w)

    keep = [c for c in canvases if fit(c) >= detail]
    if keep:
        return min(keep, key=lambda c: (int(abs(c[1] / c[0] - aspect) / 0.08), c[0] * c[1]))
    return max(canvases, key=lambda c: (fit(c), -abs(c[1] / c[0] - aspect)))


def letterbox_scale(h: int, w: int, canvas: Tuple[int, int]) -> Tuple[float, int, int]:
    scale = min(canvas[0] / h, canvas[1] / w)
    return scale, int(round(h * scale)), int(round(w * scale))


def crop_width(quad: np.ndarray, buckets: Sequence[int]) -> Tuple[int, int]:
    """(true width, bucket width) of a quad rectified to height 32."""
    q = np.asarray(quad, np.float64)
    w_src = max(np.linalg.norm(q[1] - q[0]), np.linalg.norm(q[2] - q[3]))
    h_src = max(np.linalg.norm(q[3] - q[0]), np.linalg.norm(q[2] - q[1]))
    true_w = max(8, min(int(round(CROP_H * w_src / max(h_src, 1e-6))), buckets[-1]))
    return true_w, next((b for b in buckets if true_w <= b), buckets[-1])


def letterbox(gray: torch.Tensor, canvas: Tuple[int, int]) -> Tuple[torch.Tensor, float]:
    """(H, W) uint8 photo -> its (ch, cw) uint8 canvas (bilinear, top left,
    zeros elsewhere) and the scale."""
    scale, oh, ow = letterbox_scale(gray.shape[0], gray.shape[1], canvas)
    small = F.interpolate(gray.float()[None, None], size=(oh, ow), mode="bilinear", align_corners=False)[0, 0]
    out = torch.zeros(canvas, dtype=torch.uint8, device=gray.device)
    out[:oh, :ow] = torch.round(small).clamp(0, 255).to(torch.uint8)
    return out, scale


# ----------------------------------------------------------------------
# Crops
# ----------------------------------------------------------------------


def rect_to_quad(quad: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """The homography taking the output rectangle's corner pixels (0, 0),
    (out_w - 1, 0), (out_w - 1, out_h - 1), (0, out_h - 1) to the quad's
    corners, from the four correspondences."""
    dst = [(0, 0), (out_w - 1, 0), (out_w - 1, out_h - 1), (0, out_h - 1)]
    a, b = [], []
    for (x, y), (u, v) in zip(dst, np.asarray(quad, np.float64)):
        a.append([x, y, 1, 0, 0, 0, -x * u, -y * u])
        a.append([0, 0, 0, x, y, 1, -x * v, -y * v])
        b += [u, v]
    h = np.linalg.lstsq(np.array(a), np.array(b), rcond=None)[0]
    return np.append(h, 1.0).reshape(3, 3)


def warp_crop(gray: torch.Tensor, quad: np.ndarray, true_w: int, bucket_w: int) -> torch.Tensor:
    """The quad of the (H, W) uint8 photo rectified to (32, bucket_w) uint8:
    bilinear samples (the border replicated), taken at k times the size and
    averaged down k x k when the line is k times taller than 32 (k <= 4),
    the columns past ``true_w`` repeating the last one."""
    q = np.asarray(quad, np.float64)
    h_src = max(np.linalg.norm(q[3] - q[0]), np.linalg.norm(q[2] - q[1]))
    k = int(np.clip(round(h_src / CROP_H), 1, 4))
    ow, oh = true_w * k, CROP_H * k
    m = torch.tensor(rect_to_quad(q, ow, oh), dtype=torch.float64, device=gray.device)
    ys, xs = torch.meshgrid(
        torch.arange(oh, dtype=torch.float64, device=gray.device),
        torch.arange(ow, dtype=torch.float64, device=gray.device), indexing="ij")
    den = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    sx = ((m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / den).clamp(0, gray.shape[1] - 1)
    sy = ((m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / den).clamp(0, gray.shape[0] - 1)
    x0 = sx.floor().long().clamp(max=gray.shape[1] - 1)
    y0 = sy.floor().long().clamp(max=gray.shape[0] - 1)
    x1 = (x0 + 1).clamp(max=gray.shape[1] - 1)
    y1 = (y0 + 1).clamp(max=gray.shape[0] - 1)
    fx, fy = sx - x0, sy - y0
    g = gray.double()
    top = g[y0, x0] + fx * (g[y0, x1] - g[y0, x0])
    bot = g[y1, x0] + fx * (g[y1, x1] - g[y1, x0])
    crop = torch.round(top + fy * (bot - top)).clamp(0, 255)
    if k > 1:
        crop = torch.round(crop.reshape(CROP_H, k, true_w, k).mean((1, 3)))
    if bucket_w > true_w:
        crop = torch.cat([crop, crop[:, -1:].expand(-1, bucket_w - true_w)], 1)
    return crop.to(torch.uint8)


def contrast_stretch(crops: torch.Tensor, lo: float = 10.0, hi: float = 90.0) -> torch.Tensor:
    """Each crop's 10th..90th percentile (linear) stretched to 0..255."""
    flat = crops.float().reshape(crops.shape[0], -1)
    qs = torch.quantile(flat, torch.tensor([lo / 100, hi / 100], device=flat.device), dim=1)
    low, high = qs[0][:, None, None], qs[1][:, None, None]
    return ((crops.float() - low) * (255.0 / (high - low).clamp(min=1.0))).clamp(0, 255)


# ----------------------------------------------------------------------
# The judge
# ----------------------------------------------------------------------


def _log_softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(1, keepdims=True)
    return z - np.log(np.exp(z).sum(1, keepdims=True))


def ctc_best_emissions(logp: np.ndarray, labels: Sequence[int], blank: int = 0) -> float:
    """Sum of the log probabilities at the frames where the most probable
    CTC alignment of ``labels`` to the (T, C) ``logp`` emits each label (the
    first frame of each label's run): the log of the confidence a greedy
    read of that alignment would report. -inf where no alignment fits."""
    ext = [blank]
    for c in labels:
        ext += [c, blank]
    ext = np.array(ext)
    s_n, t_n = len(ext), logp.shape[0]
    if len(labels) > t_n:
        return -np.inf
    score = logp[:, ext]
    skip_ok = np.zeros(s_n, bool)
    skip_ok[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
    d = np.full(s_n, -np.inf)
    d[0] = score[0, 0]
    d[1] = score[0, 1]
    back = np.zeros((t_n, s_n), np.int64)
    back[0] = np.arange(s_n)
    for t in range(1, t_n):
        cand = np.stack([d, np.r_[-np.inf, d[:-1]], np.where(skip_ok, np.r_[-np.inf, -np.inf, d[:-2]], -np.inf)])
        k = cand.argmax(0)
        back[t] = np.arange(s_n) - k
        d = cand.max(0) + score[t]
    s = s_n - 1 if d[-1] >= d[-2] else s_n - 2
    if not np.isfinite(d[s]):
        return -np.inf
    states = [s]
    for t in range(t_n - 1, 0, -1):
        s = back[t, s]
        states.append(s)
    states = states[::-1]
    total, prev = 0.0, -1
    for t, st in enumerate(states):
        if ext[st] != blank and st != prev:
            total += logp[t, ext[st]]
        prev = st
    return float(total)


def _cross(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def _inside(points: np.ndarray, quad: np.ndarray, tol: float) -> np.ndarray:
    """Which (N, 2) points lie inside the convex quad grown by ``tol`` pixels."""
    q = np.asarray(quad, np.float64)
    turn = _cross(q[1] - q[0], q[2] - q[1]) + _cross(q[3] - q[2], q[0] - q[3])
    sign = 1.0 if turn >= 0 else -1.0
    inside = np.ones(len(points), bool)
    for i in range(4):
        a, b = q[i], q[(i + 1) % 4]
        n = np.linalg.norm(b - a)
        if n > 0:
            inside &= sign * _cross(b - a, points - a) / n >= -tol
    return inside


def judge_detection(region: np.ndarray, affinity: np.ndarray, quads_map: List[np.ndarray], det: Dict) -> Dict[str, float]:
    """One photo's detection readings (maps at canvas / 2, quads in map
    pixels). A text peak is the best region score of a 4-connected piece of
    the thresholded maps of at least ``min_size_px`` pixels whose peak
    passes ``text_threshold``; a quad lies on nothing where its best
    reference scores stay under both thresholds that make a piece
    (``low_text`` on the region, ``link_threshold`` on the affinity).
    ``peaks``, ``missed``: text peaks, and those no quad covers; ``quads``,
    ``extra``: quads, and those on nothing."""
    from scipy import ndimage

    mask = (region > det["low_text"]) | (affinity > det["link_threshold"])
    labels, n = ndimage.label(mask)
    out = {"peaks": 0, "missed": 0, "quads": len(quads_map), "extra": 0}
    if n:
        idx = np.arange(1, n + 1)
        sizes = ndimage.sum_labels(np.ones_like(region), labels, idx)
        peaks = ndimage.maximum(region, labels, idx)
        where = ndimage.maximum_position(region, labels, idx)
        for size, peak, (py, px) in zip(sizes, peaks, where):
            if size < det["min_size_px"] or peak < det["text_threshold"]:
                continue
            out["peaks"] += 1
            pt = np.array([[px, py]], np.float64)
            if not any(_inside(pt, qd, 1.0)[0] for qd in quads_map):
                out["missed"] += 1
    h, w = region.shape
    for qd in quads_map:
        x0, y0 = np.floor(qd.min(0)).astype(int)
        x1, y1 = np.ceil(qd.max(0)).astype(int)
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
        r_best = a_best = 0.0
        if x1 >= x0 and y1 >= y0:
            ys, xs = np.mgrid[y0 : y1 + 1, x0 : x1 + 1]
            sel = _inside(np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64), qd, 0.5)
            if sel.any():
                r_best = float(region[ys.ravel()[sel], xs.ravel()[sel]].max())
                a_best = float(affinity[ys.ravel()[sel], xs.ravel()[sel]].max())
        if r_best < det["low_text"] and a_best < det["link_threshold"]:
            out["extra"] += 1
    return out


class OCRReference:
    """The reference on one device, with ``q`` on every product."""

    def __init__(self, config: Dict, root: str, device, q: Q):
        self.cfg = config
        self.device = device
        self.q = q
        self.craft = load_params(f"{root}/{config['craft']}", device)
        self.crnn = load_params(f"{root}/{config['crnn']}", device)
        self.chars = config["charset"]
        eng = config["engine"]
        self.canvases = [tuple(c) for c in eng["canvases"]]
        self.buckets = list(eng["width_buckets"])
        self.det = eng["detection"]
        self.contrast_ths = eng["contrast_ths"]

    def labels(self, text: str) -> List[int]:
        return [self.chars.index(ch) + 1 for ch in text]

    @torch.no_grad()
    def judge_photo(self, gray_u8: np.ndarray, answers) -> Dict[str, float]:
        """The readings of one photo's answers [(quad in photo pixels, text,
        confidence)]: ``judge_detection``'s, and ``read_gaps``, each returned
        text's gap between its confidence and the reference's."""
        gray = torch.from_numpy(np.ascontiguousarray(gray_u8)).to(self.device)
        canvas_hw = pick_canvas(gray.shape[0], gray.shape[1], self.canvases, self.cfg["engine"]["detail_scale"])
        canvas, scale = letterbox(gray, canvas_hw)
        region, affinity = (m[0].cpu().numpy() for m in craft_maps(self.craft, canvas[None], self.q))
        quads_canvas = [np.asarray(a[0], np.float64) * scale for a in answers]
        out = judge_detection(region, affinity, [qd / 2.0 for qd in quads_canvas], self.det)

        read_gaps = []
        out.update(texts=0, texts_differ=0)
        by_bucket: Dict[int, List[Tuple[int, int]]] = {}
        for j, qd in enumerate(quads_canvas):
            true_w, bucket_w = crop_width(qd, self.buckets)
            by_bucket.setdefault(bucket_w, []).append((j, true_w))
        for bucket_w, items in by_bucket.items():
            crops = torch.stack([
                warp_crop(gray, np.asarray(answers[j][0], np.float64), tw, bucket_w) for j, tw in items])
            reads = [crnn_logits(self.crnn, crops, self.q).double().cpu().numpy()]
            for r, (j, true_w) in enumerate(items):
                frames = max(true_w // 4 - 1, 1)
                text, conf = answers[j][1], answers[j][2]
                lab = self.labels(text)
                # the program keeps a contrast-stretched re-read of a crop
                # whose first read fell under contrast_ths
                weak = _greedy(reads[0][r, :frames])[1] < 2.5 * self.contrast_ths
                if weak and len(reads) == 1:
                    reads.append(crnn_logits(self.crnn, contrast_stretch(crops), self.q).double().cpu().numpy())
                got = math.log(max(conf, FLOOR))
                gap = min(
                    abs(got - max(ctc_best_emissions(_log_softmax(lg[r, :frames]), lab), math.log(FLOOR)))
                    for lg in reads[: 2 if weak else 1])
                read_gaps.append(gap / len(lab))
                reads_as = ["".join(self.chars[c - 1] for c in _greedy(lg[r, :frames])[0])
                            for lg in reads[: 2 if weak else 1]]
                out["texts"] += 1
                out["texts_differ"] += int(text not in reads_as)
        out["read_gaps"] = read_gaps
        return out


def _greedy(logits: np.ndarray) -> Tuple[List[int], float]:
    """Greedy CTC read of (T, C) logits: (labels, confidence), the
    confidence the product of the best softmax probabilities over the
    frames it emits (0 for none)."""
    lp = logits - logits.max(1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(1, keepdims=True))
    best = logits.argmax(1)
    prev = np.concatenate([[-1], best[:-1]])
    keep = (best != 0) & (best != prev)
    return best[keep].tolist(), (float(np.exp(lp.max(1)[keep].sum())) if keep.any() else 0.0)


# ----------------------------------------------------------------------
# The control: this reference in the program's place, in float8
# ----------------------------------------------------------------------


class ControlCRAFT(torch.nn.Module):
    """Stands in for the engine's detector: takes what the engine hands its
    folded-stem CRAFT, (B, 1, H, W) raw gray, returns (B, 2, H/2, W/2)."""

    def __init__(self, params, q: Q):
        super().__init__()
        self.p, self.q = params, q

    def forward(self, x):
        region, affinity = craft_maps(self.p, x[:, 0].float(), self.q)
        return torch.stack([region, affinity], 1)


class ControlCRNN(torch.nn.Module):
    """Stands in for the engine's recognizer: (B, 1, 32, W) in [-1, 1] -> logits."""

    def __init__(self, params, q: Q):
        super().__init__()
        self.p, self.q = params, q

    def forward(self, x):
        return crnn_logits(self.p, (x[:, 0].float() + 1.0) * 127.5, self.q)


def install_control(engine, ref: OCRReference) -> None:
    engine.craft = ControlCRAFT(ref.craft, ref.q)
    engine.crnn = ControlCRNN(ref.crnn, ref.q)


# ----------------------------------------------------------------------
# Work the inputs need (the yardstick of mfu)
# ----------------------------------------------------------------------


def _meta_params(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k.split("/", 1)[1]: torch.empty(z[k].shape, device="meta") for k in z.files}


def count_flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def craft_flops(root: str, config: Dict, canvas: Tuple[int, int]) -> int:
    """FLOPs of one detector pass over a canvas (products and convolutions)."""
    p = _meta_params(f"{root}/{config['craft']}")
    return count_flops(lambda: craft_maps(p, torch.empty((1,) + tuple(canvas), device="meta"), lambda x: x))


def crnn_flops(root: str, config: Dict, width: int) -> int:
    """FLOPs of one recognizer pass over a crop of the bucket's width."""
    p = _meta_params(f"{root}/{config['crnn']}")
    return count_flops(lambda: crnn_logits(p, torch.empty((1, CROP_H, width), device="meta"), lambda x: x))


def photo_flops(answers, gray_shape, config: Dict, craft_by_canvas: Dict, crnn_by_width: Dict) -> int:
    """The detector at the photo's canvas, the recognizer at each returned
    box's bucket width, once more for each box whose confidence shows the
    contrast re-read ran."""
    eng = config["engine"]
    canvases = [tuple(c) for c in eng["canvases"]]
    canvas = pick_canvas(gray_shape[0], gray_shape[1], canvases, eng["detail_scale"])
    total = craft_by_canvas[canvas]
    for quad, _, conf in answers:
        _, bucket_w = crop_width(quad, eng["width_buckets"])
        total += crnn_by_width[bucket_w] * (2 if conf < eng["contrast_ths"] else 1)
    return total

