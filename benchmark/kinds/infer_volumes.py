"""Whole-volume inference over a test set, as the port's CLI runs it: the
generator of every traffic mix of kind "infer_volumes".

The window is one call of infer/engine.py:run_inference on a loader that
sends the pool's cases in a seeded order and stops at the deadline: each
case is staged (the engine's staging thread), blended, scored by Dice, its
labelmap argmax'ed to uint8 on the host and measured by volumetry; no
export and no figures. The loop is closed: a case goes in when the engine
asks for it. volumes_per_s is the cases completed over the call's wall time.
The benchmark times each case's pieces on the way (Capture): the device
time of the windowed forward and blend (CUDA events around the engine's
call), and on the host clock the Dice, the argmax copy, the volumetry and
what lies between them.

Set-up builds the model of the configuration on the card, loads the seeded
weights, makes the cases, and runs the same call over `warmup_cases` cases
(every kernel built and loaded, every shape of the mix seen).

With --trace 1 two short stretches follow the window: run_inference with
`trace_cases` of its iterations, past the first two (the first's staging
overlaps nothing; the profiler starts in the second), traced by
torch.profiler (idle share within the stretch, and the breakdown),
and over `level_cases` cases with CUDA events at the entry and exit of
every top-level module (device ms of each level group, as
chip_smoke.py:level_times takes them: the time between two events goes to
the level of the earlier one, so a routed decoder block counts to its
level).

What is judged: the blended logits of a seeded sample of the window's
cases and the uint8 labelmaps of a seeded sample spread over the whole
window (every case of the first `logit_sample_of`, then one drawn from
each further block of `label_block` cases), against the plain reference's
on the same weights and volume (reference.blend_volume in float32, TF32
off), each error read against the error the same reference makes in bf16
(case_numbers), computed once the window has closed and the program's
state is freed. Only the sampled labelmaps are held: holding every case's
would leave the engine no host memory to reuse, so each case's argmax
copy would fault in 16 MB of fresh pages, host work a user's run has not.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark import common, data, flops, reference
from benchmark.trace import Tracer, summarise


class CaseLoader:
    """The engine's test loader: collated batches of one case, the pool's
    cases in `order`; with a deadline it stops sending once the host clock
    passes it (the first case always goes). `at` maps a case's index to a
    callback run when the engine asks for that case (the index one past
    the order: when it asks for more)."""

    def __init__(self, cases: List[dict], order, deadline=None, at=None):
        self.cases, self.order, self.deadline = cases, order, deadline
        self.at = at or {}
        self.sent = 0

    def __len__(self) -> int:
        return len(self.order)

    def __iter__(self):
        for i, k in enumerate(self.order):
            if i in self.at:
                self.at[i]()
            if (self.deadline is not None and self.sent
                    and time.perf_counter() >= self.deadline):
                return
            c = self.cases[int(k)]
            shape = tuple(c["image"].shape[2:])
            self.sent += 1
            with torch.profiler.record_function("bench.next_case"):
                batch = {"image": c["image"], "label": c["label"],
                         "label_meta": [{"affine": c["affine"],
                                         "original_affine": c["affine"],
                                         "spatial_shape": shape,
                                         "filename_or_obj":
                                             f"case{int(k)}/image.nii.gz"}]}
            yield batch
        if len(self.order) in self.at:
            self.at[len(self.order)]()


class Spans:
    """The benchmark's spans around the engine's calls into the layers
    below it: the windowed forward and blend, the Dice, the volumetry."""

    NAMES = {"sliding_window_inference": "bench.forward_blend",
             "dice_score": "bench.dice",
             "segmentation_volume_ml": "bench.volumetry"}

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        self._saved = {k: getattr(self.engine, k) for k in self.NAMES}
        for attr, span in self.NAMES.items():
            fn = self._saved[attr]

            def wrapped(*a, _fn=fn, _span=span, **kw):
                with torch.profiler.record_function(_span):
                    return _fn(*a, **kw)

            setattr(self.engine, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for k, fn in self._saved.items():
            setattr(self.engine, k, fn)
        return False


class Capture:
    """What the engine produced for the sampled cases of the window,
    taken where it hands it on: the blended logits that go to its Dice
    (for the cases in `keep`), and the uint8 labelmap that goes to its
    volumetry (for the cases in `keep_labels`). On the way it counts the
    cases that reached volumetry and times each case's pieces: CUDA events
    around the windowed forward and blend (on a card), and the host clock
    at the entry and exit of that call, of the Dice and of each
    volumetry."""

    def __init__(self, engine, keep, keep_labels, dev):
        self.engine, self.keep, self.dev = engine, set(keep), dev
        self.keep_labels = set(keep_labels)
        self.logits: Dict[int, torch.Tensor] = {}
        self.labelmaps: Dict[int, np.ndarray] = {}
        self.n_dice = 0
        self.volume_calls = 0
        self.events: List[tuple] = []
        self.host: Dict[str, List[float]] = {
            k: [] for k in ("fwd_in", "fwd_out", "dice_in", "dice_out",
                            "vol_in", "vol_out")}

    def _mark(self):
        if self.dev.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __enter__(self):
        fwd_fn = self.engine.sliding_window_inference
        dice_fn = self.engine.dice_score
        volume_fn = self.engine.segmentation_volume_ml
        self._saved = (fwd_fn, dice_fn, volume_fn)
        host = self.host

        def forward(*a, **kw):
            host["fwd_in"].append(time.perf_counter())
            e0 = self._mark()
            out = fwd_fn(*a, **kw)
            self.events.append((e0, self._mark()))
            host["fwd_out"].append(time.perf_counter())
            return out

        def dice(pred, label):
            host["dice_in"].append(time.perf_counter())
            if self.n_dice in self.keep:
                self.logits[self.n_dice] = pred
            self.n_dice += 1
            out = dice_fn(pred, label)
            host["dice_out"].append(time.perf_counter())
            return out

        def volume(labelmap, affine):
            host["vol_in"].append(time.perf_counter())
            # per case: the prediction's, then the ground truth's
            case = self.volume_calls // 2
            if self.volume_calls % 2 == 0 and case in self.keep_labels:
                self.labelmaps[case] = labelmap
            self.volume_calls += 1
            out = volume_fn(labelmap, affine)
            host["vol_out"].append(time.perf_counter())
            return out

        self.engine.sliding_window_inference = forward
        self.engine.dice_score = dice
        self.engine.segmentation_volume_ml = volume
        return self

    def __exit__(self, *exc):
        (self.engine.sliding_window_inference, self.engine.dice_score,
         self.engine.segmentation_volume_ml) = self._saved
        return False

    def forward_ms(self) -> List[float]:
        """Device ms of each case's windowed forward and blend; empty off
        a card. Read after a synchronise."""
        return [e0.elapsed_time(e1) for e0, e1 in self.events
                if e0 is not None]

    def pieces_ms(self, t_end: float) -> Dict[str, np.ndarray]:
        """Host ms of each case between the marks, for the cases whose
        every mark was taken: the forward's enqueue, its wait and the
        label's upload (up to the Dice), the Dice with its read-back, the
        argmax copy (up to the first volumetry), both volumetries, and the
        rest up to the next forward (the loader, the staging wait) or the
        window's end."""
        h = {k: np.asarray(v) for k, v in self.host.items()}
        n = min(len(h["fwd_in"]), len(h["dice_out"]), len(h["vol_out"]) // 2)
        if not n:
            return {}
        nxt = np.append(h["fwd_in"][1:n], t_end)
        vin, vout = h["vol_in"][:2 * n], h["vol_out"][:2 * n]
        out = {"enqueue": h["fwd_out"][:n] - h["fwd_in"][:n],
               "wait_upload": h["dice_in"][:n] - h["fwd_out"][:n],
               "dice": h["dice_out"][:n] - h["dice_in"][:n],
               "argmax_copy": vin[0::2] - h["dice_out"][:n],
               "volumetry": (vout - vin).reshape(n, 2).sum(1),
               "between": nxt - vout[1::2]}
        return {k: 1e3 * v for k, v in out.items()}


class LevelEvents:
    """CUDA events at the entry and exit of the model and of each of its
    top-level modules; `ms()` is the device ms of each level (n for the
    bottom) summed over the forwards."""

    def __init__(self, model, n_levels: int):
        self.marks = []
        self.hooks = []

        def level(name: str):
            return n_levels if name.startswith("bottom") else int(
                name.rsplit("_", 1)[1])

        def mark(lv):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append((e, lv))

        self.hooks.append(model.register_forward_pre_hook(
            lambda mod, args: mark(None)))
        for name, m in model.named_children():
            lv = level(name)
            self.hooks.append(m.register_forward_pre_hook(
                lambda mod, args, lv=lv: mark(lv)))
            self.hooks.append(m.register_forward_hook(
                lambda mod, args, out, lv=lv: mark(lv)))
        self.hooks.append(model.register_forward_hook(
            lambda mod, args, out: mark(None)))

    def remove(self):
        for h in self.hooks:
            h.remove()

    def ms(self) -> Dict[int, float]:
        torch.cuda.synchronize()
        out: Dict[int, float] = {}
        for (e0, lv), (e1, _) in zip(self.marks, self.marks[1:]):
            if lv is not None:
                out[lv] = out.get(lv, 0.0) + e0.elapsed_time(e1)
        return out


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, program_hook=None) -> dict:
    """One run of an inference cell. `program_hook(engine) -> undo`, for
    tests and readings, may put a fault under the window's timed path."""
    from vs_seg_tpu_torch.infer import engine
    from vs_seg_tpu_torch.models import build_model

    cfg_file, traffic = cell.config, cell.traffic
    dev = device
    roi = tuple(int(v) for v in traffic["roi"])
    cfg = common.program_config(
        cfg_file, seed=seed, sliding_window_inferer_roi_size=roi,
        pad_crop_shape_test=roi, sw_overlap=float(traffic["overlap"]),
        infer_dtype=traffic["infer_dtype"],
        quantize_transfer=bool(traffic["quantize_transfer"]),
        export_inferred_segmentations=False)
    net = reference.RefNet(cfg_file)
    model = build_model(cfg, device=dev)
    model.load_state_dict(reference.make_weights(
        net, data.sub_seed(seed, data.WEIGHTS), dev))
    common.note(t_start, "model built, weights loaded")
    cases = data.make_cases(traffic, seed, dev)
    common.note(t_start, "cases made")
    log = common.quiet_logger()

    def infer(loader):
        return engine.run_inference(cfg, model, loader, device=dev,
                                    logger=log, export=False,
                                    make_figures=False)

    warm = int(traffic["warmup_cases"])
    infer(CaseLoader(cases, data.case_order(len(cases), seed + 1, warm)))
    common.sync(dev)
    cap_n = int(math.ceil(seconds * traffic["max_cases_per_s"])) + 8
    order = data.case_order(len(cases), seed, cap_n)
    rng = np.random.default_rng(data.sub_seed(seed, data.ORDER) + 1)
    first = int(traffic["logit_sample_of"])
    keep = rng.choice(first, int(traffic["logit_sample"]), replace=False)
    block = int(traffic["label_block"])
    keep_labels = set(range(first)) | {
        lo + int(rng.integers(block)) for lo in range(first, cap_n, block)}
    setup_s = time.perf_counter() - t_start
    common.note(t_start, f"set-up done ({setup_s:.2f} s)")

    undo = program_hook(engine) if program_hook is not None else None
    try:
        t0 = time.perf_counter()
        loader = CaseLoader(cases, order, deadline=t0 + seconds)
        with Capture(engine, keep, keep_labels, dev) as cap:
            dice, compute = infer(loader)
            common.sync(dev)
        t_end = time.perf_counter()
        wall = t_end - t0
    finally:
        if undo is not None:
            undo()
    done = loader.sent
    forward_ms = cap.forward_ms()
    pieces = cap.pieces_ms(t_end)
    # the engine's own compute time a case (staged upload to synchronised
    # logits) splits the host's wait for the forward from the upload after
    n = len(pieces.get("enqueue", ()))
    if n and len(compute) >= n:
        wait = 1e3 * np.asarray(compute[:n]) - pieces["enqueue"]
        pieces["wait"] = wait
        pieces["upload"] = pieces["wait_upload"] - wait
    common.note(t_start, f"window: {done} cases in {wall:.3f} s")
    if forward_ms:
        common.note(t_start, "forward and blend on the device "
                    f"{float(np.mean(forward_ms)):.2f} ms a case "
                    f"(min {min(forward_ms):.2f}, max {max(forward_ms):.2f})")
    for stat, fn in (("mean", np.mean), ("median", np.median),
                     ("max", np.max)):
        common.note(t_start, f"host ms a case, {stat}: " + ", ".join(
            f"{k} {float(fn(v)):.2f}" for k, v in pieces.items()))

    windows = len(reference.window_starts(traffic["volume"], traffic["roi"],
                                          traffic["overlap"]))
    flop_case = windows * flops.forward_flops(cfg_file, traffic["roi"])
    ctx = {"kind": "infer", "cases": done, "wall_s": wall,
           "forward_ms": forward_ms,
           "host_pieces_ms": {k: float(np.mean(v))
                              for k, v in pieces.items()},
           "flop_per_case": flop_case, "device_kind": common.device_kind(dev),
           "peaks": common.peaks()}
    if trace:
        # engine iterations skip + 1 .. skip + n, past the pipeline's fill,
        # with the profiler started an iteration before the stretch opens:
        # the engine asks for case i + 2 as iteration i begins
        n, skip = int(traffic["trace_cases"]), 1
        tracer = Tracer(dev)
        with Spans(engine):
            infer(CaseLoader(cases, order[:skip + n + 3],
                             at={skip + 2: tracer.profile,
                                 skip + 3: tracer.open,
                                 skip + n + 3: tracer.stop}))
        ctx["trace"] = summarise(tracer.events)
        ctx["trace_cases"] = n
        if dev.type == "cuda":
            lv = LevelEvents(model, len(cfg_file["strides"]))
            m = int(traffic["level_cases"])
            try:
                infer(CaseLoader(cases, order[:m]))
                ctx["level_ms_per_case"] = {
                    k: v / m for k, v in lv.ms().items()}
            finally:
                lv.remove()
        ctx["group_work"] = {
            name: flops.group_work(cfg_file, traffic["roi"], windows, lvs)
            for name, lvs in traffic["level_groups"].items()}
        ctx["level_groups"] = traffic["level_groups"]
    peak = common.peak_memory(dev)
    common.note(t_start, f"peak {peak / 2**30:.2f} GiB; reference next")

    del model
    logits, labelmaps = cap.logits, cap.labelmaps
    volume_calls = cap.volume_calls
    del cap
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(net, seed, cases, order[:done], dice[:done], logits,
                     labelmaps, traffic, dev)
    common.note(t_start, "reference done")
    # cases sent whose volumetry never ran, or ran other than twice
    failed = done - volume_calls // 2 + (volume_calls != 2 * done)
    return {"end_to_end": {"volumes_per_s": done / wall,
                           "setup_s": setup_s},
            "attempted": done, "failed": failed, "checks": checks,
            "memory_peak_bytes": peak, "ctx": ctx}


# Voxels added to both counts of label_ratio, so that a volume whose
# labels the bf16 reference flips nowhere reads about 1 and not 0 / 0.
LABEL_FLOOR = 10


class Ref(NamedTuple):
    logits: torch.Tensor      # (O, H, W, D) blended, float32
    arg: torch.Tensor         # (H, W, D) labels
    dice: float               # against the case's label
    bf16_err: float           # L2 norm of the bf16 reference's error
    bf16_flips: int           # voxels whose label the bf16 reference flips


def blended(net, p, case: dict, traffic: dict, dev, prec: str):
    """The reference's blended logits (O, H, W, D) of one case."""
    image = torch.from_numpy(case["image"][0, 0]).to(dev)
    with reference.fp32_exact():
        return reference.blend_volume(
            net, p, image, traffic["roi"], float(traffic["overlap"]),
            float(traffic["sigma_scale"]), prec=prec)


def reference_outputs(net, p, case: dict, traffic: dict, dev) -> Ref:
    """The reference's outputs on one case: in float32, and the size of
    the error that the configuration's precision, bf16, gives the plain
    reference itself."""
    logits = blended(net, p, case, traffic, dev, "f32")
    arg = logits.argmax(0)
    label = torch.from_numpy(case["label"][0, 0]).to(dev)
    low = blended(net, p, case, traffic, dev, "bf16")
    return Ref(logits, arg, reference.hard_dice(arg, label),
               float(torch.linalg.vector_norm(low - logits)),
               int((low.argmax(0) != arg).sum()))


def case_numbers(ref: Ref, labels, dice: float, logits=None) -> dict:
    """One case's numbers against the reference's. Compared: label_ratio,
    the voxels whose label differs from the reference's over those the
    bf16 reference flips (each + LABEL_FLOOR), and with the blended logits
    (O, H, W, D), logit_ratio, their L2 error over the bf16 reference's:
    both read about 1 for a sound bf16 computation and are steady from
    seed to seed, where the plain errors move with how much each seed's
    random network amplifies rounding. Also the plain shares and gaps."""
    flips = int((labels != ref.arg).sum())
    out = {"label_ratio": (flips + LABEL_FLOOR)
           / (ref.bf16_flips + LABEL_FLOOR),
           "label_mismatch": flips / labels.numel(),
           "dice_gap": abs(float(dice) - ref.dice)}
    if logits is not None:
        err = float(torch.linalg.vector_norm(logits - ref.logits))
        out["logit_ratio"] = err / ref.bf16_err
        out["logit_err"] = err / float(torch.linalg.vector_norm(ref.logits))
    return out


def worst_of(rows) -> Dict[str, float]:
    keys = {k for r in rows for k in r}
    return {k: common.worst([r[k] for r in rows if k in r]) for k in keys}


def compare(net, seed, cases, order, dice, logits, labelmaps, traffic,
            dev) -> Dict[str, float]:
    """Each number's worst case over the window's sampled cases: their
    labelmaps and Dice, and the blended logits of those in `logits`."""
    p = reference.make_weights(net, data.sub_seed(seed, data.WEIGHTS), dev)
    refs, rows = {}, []
    for i in sorted(labelmaps):
        k = int(order[i])
        if k not in refs:
            refs[k] = reference_outputs(net, p, cases[k], traffic, dev)
        labels = torch.from_numpy(np.ascontiguousarray(labelmaps[i])).to(
            dev).long()
        got = (logits[i][0].permute(3, 0, 1, 2).float() if i in logits
               else None)
        rows.append(case_numbers(refs[k], labels, dice[i], got))
    return worst_of(rows) if rows else {}


def control(cell, seed: int, device) -> Dict[str, float]:
    """The numbers of the control: the reference in float8 in the
    program's place, on this seed's weights and pool."""
    traffic, dev = cell.traffic, device
    net = reference.RefNet(cell.config)
    p = reference.make_weights(net, data.sub_seed(seed, data.WEIGHTS), dev)
    rows = []
    for case in data.make_cases(traffic, seed, dev):
        ref = reference_outputs(net, p, case, traffic, dev)
        q = blended(net, p, case, traffic, dev, "fp8")
        label = torch.from_numpy(case["label"][0, 0]).to(dev)
        rows.append(case_numbers(ref, q.argmax(0), reference.hard_dice(
            q.argmax(0), label), q))
    return worst_of(rows)


# Faults the cell can have, for the tests and the readings: each puts a
# fault under the timed path (run's program_hook) and returns its undo.

def fault_half_batch(engine):
    """Half of every batch of windows left out of the blend, which takes
    the mean over the rest."""
    from vs_seg_tpu_torch.infer import sliding_window

    blend = sliding_window.blend_windows

    def half(vol, roi, starts, mask, predictor, fn, imp, sw_batch_size):
        mask = np.array(mask, copy=True)
        for lo in range(0, len(mask), sw_batch_size):
            mask[lo + max(1, sw_batch_size // 2):lo + sw_batch_size] = 0
        return blend(vol, roi, starts, mask, predictor, fn, imp,
                     sw_batch_size)

    sliding_window.blend_windows = half
    return lambda: setattr(sliding_window, "blend_windows", blend)


def fault_altered(engine):
    """One case's answer altered where it is produced: the second case's
    blended logits come out with their classes swapped."""
    infer = engine.sliding_window_inference
    calls = []

    def altered(*a, **kw):
        out = infer(*a, **kw)
        calls.append(1)
        return out.flip(-1) if len(calls) == 2 else out

    engine.sliding_window_inference = altered
    return lambda: setattr(engine, "sliding_window_inference", infer)


FAULTS = {"half_batch": fault_half_batch, "altered": fault_altered}
