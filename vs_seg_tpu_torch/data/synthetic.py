"""Synthetic NIFTI dataset generator (tests and smoke runs without TCIA):
the port's copy of vs_seg_tpu/data/synthetic.py, byte for byte the same
files from the same seed.

Writes the on-disk layout the reference expects: data_root/input_data/<case>/
vs_gk_{t1,t2}_ref{T1,T2}.nii.gz + vs_gk_seg_ref{T1,T2}.nii.gz, plus a split
CSV (case,split rows like params/split_TCIA.csv).

Volumes get a deliberately NON-RAS (LPS-ish, negative first diagonal) affine
so the Orientationd reorientation and the original_affine export round trip
are exercised.

    python -m vs_seg_tpu_torch.data.synthetic ROOT [--n_test 2] [--shape H,W,D]
"""

from __future__ import annotations

import csv
import os

import numpy as np

from vs_seg_tpu_torch.data import nifti


def _smooth_noise(rng: np.random.Generator, shape) -> np.ndarray:
    """Cheap band-limited noise: small grid, trilinear-upsampled."""
    small = tuple(max(2, s // 4) for s in shape)
    base = rng.normal(size=small).astype(np.float32)
    out = base
    for axis, (s_small, s_full) in enumerate(zip(small, shape)):
        idx = np.linspace(0, s_small - 1, s_full)
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, s_small - 1)
        frac = (idx - lo).astype(np.float32)
        taken_lo = np.take(out, lo, axis=axis)
        taken_hi = np.take(out, hi, axis=axis)
        shape_b = [1] * out.ndim
        shape_b[axis] = s_full
        f = frac.reshape(shape_b)
        out = taken_lo * (1 - f) + taken_hi * f
    return out


def _case_volumes(rng: np.random.Generator, shape):
    """(image, label): noisy background + a bright ellipsoid 'tumor'."""
    image = _smooth_noise(rng, shape) * 0.5 + rng.normal(
        size=shape).astype(np.float32) * 0.1
    center = np.array([rng.uniform(0.3, 0.7) * s for s in shape])
    radii = np.array([max(2.0, 0.12 * s) for s in shape])
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                        indexing="ij")
    dist = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii))
    label = (dist <= 1.0).astype(np.uint8)
    image = image + 2.0 * label.astype(np.float32)
    return image.astype(np.float32), label


# First case names per split match params/split_debug.csv (reference
# params/split_debug.csv:1-6) so `--debug` runs work on a synthetic root
# without a custom --split flag.
_DEBUG_NAMES = {"training": ["vs_gk_1", "vs_gk_2"],
                "validation": ["vs_gk_182", "vs_gk_183"],
                "test": ["vs_gk_202", "vs_gk_203"]}


def generate_dataset(root: str, n_train: int = 2, n_val: int = 2,
                     n_test: int = 2, shape=(48, 48, 16), seed: int = 0) -> str:
    """Create the dataset under `root`; returns the split CSV path."""
    rng = np.random.default_rng(seed)
    rows = []
    case_idx = 0
    for split, count in (("training", n_train), ("validation", n_val),
                         ("test", n_test)):
        for k in range(count):
            debug_names = _DEBUG_NAMES[split]
            case = (debug_names[k] if k < len(debug_names)
                    else f"vs_gk_synth_{case_idx}")
            case_dir = os.path.join(root, "input_data", case)
            os.makedirs(case_dir, exist_ok=True)
            image, label = _case_volumes(rng, shape)
            # LPS-ish affine: negative R/A diagonals + per-case jitter, so
            # RAS reorientation is a real permutation/flip and the exported
            # affine provably differs from the working (RAS) affine.
            affine = np.diag([-1.0, -1.0, 1.5, 1.0])
            affine[:3, 3] = rng.uniform(-20.0, 20.0, size=3)
            for ds, tag in (("T1", "t1"), ("T2", "t2")):
                nifti.save(nifti.NiftiImage(image, affine), os.path.join(
                    case_dir, f"vs_gk_{tag}_ref{ds}.nii.gz"))
                nifti.save(nifti.NiftiImage(label, affine), os.path.join(
                    case_dir, f"vs_gk_seg_ref{ds}.nii.gz"))
            rows.append((case, split))
            case_idx += 1
    csv_path = os.path.join(root, "split_synthetic.csv")
    with open(csv_path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return csv_path


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Generate a synthetic VS_Seg-layout dataset")
    parser.add_argument("root", help="output dataset root")
    parser.add_argument("--n_train", type=int, default=2)
    parser.add_argument("--n_val", type=int, default=2)
    parser.add_argument("--n_test", type=int, default=2)
    parser.add_argument("--shape", type=str, default="48,48,16",
                        help="H,W,D of each volume")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split(","))
    csv_path = generate_dataset(args.root, args.n_train, args.n_val,
                                args.n_test, shape=shape, seed=args.seed)
    print(f"wrote {args.n_train}+{args.n_val}+{args.n_test} cases under "
          f"{args.root}; split: {csv_path}")


if __name__ == "__main__":
    main()
