"""CLI for the offline preprocessing toolchain — the runnable counterpart
of the reference's three scripts, without 3D Slicer; the port's copy of
vs_seg_tpu/preprocessing/__main__.py, with its subcommands, flags, defaults
and exit codes:

  python -m vs_seg_tpu_torch.preprocessing restructure -i <TCIA_raw> -o <cases>
      (reference TCIA_data_convert_into_convenient_folder_structure.py)
  python -m vs_seg_tpu_torch.preprocessing convert -i <cases> -o <out>
      [--register no_registration|T1|T2]
      (reference data_conversion.py main, :347-527 — same per-case outputs:
       vs_gk_<n>/vs_gk_{t1,t2,seg}_ref{T1,T2}.nii.gz, same .tfm conventions
       inv_T1_LPS_to_T2_LPS.tfm / inv_T2_LPS_to_T1_LPS.tfm, and with
       --register the reference's exact export set: both images on the
       target grid + the target modality's own contours rasterized there,
       data_conversion.py:445-526)
  python -m vs_seg_tpu_torch.preprocessing bids -i <cases> -o <out>
      (reference createBIDSdataset/data_conversion_BIDS.py)
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import re
import sys

import numpy as np

from vs_seg_tpu_torch.data import nifti
from vs_seg_tpu_torch.preprocessing.convert import (
    convert_case, extract_rtstruct_contours, load_contours_json, load_series,
    rasterize_contours, restructure_tcia,
)
from vs_seg_tpu_torch.preprocessing.dicom import read_dicom
from vs_seg_tpu_torch.preprocessing.registration import (
    read_itk_tfm, resample_to_reference,
)

_CASE_RE = re.compile(r"_([0-9]+)_t[1-2]$")


def _case_pairs(input_root: str):
    cases = {}
    for p in sorted(glob.glob(os.path.join(input_root, "vs_gk_*"))):
        m = _CASE_RE.search(os.path.basename(p.rstrip("/")))
        if not m:
            continue
        cases.setdefault(int(m.group(1)), {})[p.rstrip("/")[-2:]] = p
    return cases


def _load_image(case_dir: str):
    imgs = sorted(os.path.join(case_dir, f) for f in os.listdir(case_dir)
                  if f.startswith("IMG") and f.endswith(".dcm"))
    vol, aff = load_series(imgs)
    return nifti.NiftiImage(vol.astype(np.float32), aff)


def _load_case_contours(case_dir: str, roi_pattern: str):
    cj = os.path.join(case_dir, "contours.json")
    rt = os.path.join(case_dir, "RTSS.dcm")
    if os.path.exists(cj):
        return load_contours_json(cj)
    if os.path.exists(rt):
        return extract_rtstruct_contours(read_dicom(rt), roi_pattern)
    return None


def _convert_registered(n: int, dirs, out_dir: str, target: str,
                        roi_pattern: str):
    """--register T1|T2: resample the other modality (and use the target's
    own contours) onto the target grid — reference data_conversion.py
    :445-526."""
    moving_tag = "t2" if target == "T1" else "t1"
    tfm_name = (f"inv_{moving_tag.upper()}_LPS_to_{target}_LPS.tfm")
    fixed = _load_image(dirs[target.lower()])
    moving = _load_image(dirs[moving_tag])
    tfm = read_itk_tfm(os.path.join(dirs[moving_tag], tfm_name))
    moved = resample_to_reference(moving, fixed, tfm)
    os.makedirs(out_dir, exist_ok=True)
    nifti.save(fixed, os.path.join(
        out_dir, f"vs_gk_{target.lower()}_ref{target}.nii.gz"))
    nifti.save(moved, os.path.join(
        out_dir, f"vs_gk_{moving_tag}_ref{target}.nii.gz"))
    contours = _load_case_contours(dirs[target.lower()], roi_pattern)
    if contours:
        seg = rasterize_contours(contours, fixed.affine,
                                 np.asarray(fixed.data).shape[:3])
        nifti.save(nifti.NiftiImage(seg, fixed.affine),
                   os.path.join(out_dir, f"vs_gk_seg_ref{target}.nii.gz"))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser(prog="vs_seg_tpu_torch.preprocessing",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("restructure", help="TCIA download -> case folders")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--incomplete-ok", action="store_true",
                   help="skip the reference's completeness asserts")
    p.add_argument("--on-unclassified", default="raise",
                   choices=("raise", "warn", "skip"))

    p = sub.add_parser("convert", help="case folders -> training NIFTIs")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--register", default="no_registration",
                   choices=("no_registration", "T1", "T2"))
    p.add_argument("--roi-pattern",
                   default=r".*(vs|tv|tumor|tumour|schwannoma).*")

    p = sub.add_parser("bids", help="case folders -> BIDS dataset")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)

    args = parser.parse_args(argv)

    if args.cmd == "restructure":
        created = restructure_tcia(
            args.input, args.output,
            require_complete=not args.incomplete_ok,
            on_unclassified=args.on_unclassified)
        logging.info("restructured %d case folders", len(created))
        return 0

    if args.cmd == "bids":
        from vs_seg_tpu_torch.preprocessing.bids import build_bids_dataset
        written = build_bids_dataset(args.input, args.output)
        logging.info("wrote %d BIDS raw images", len(written))
        return 0

    cases = _case_pairs(args.input)
    if not cases:
        logging.error("no vs_gk_<n>_{t1,t2} case folders under %s",
                      args.input)
        return 1
    for n, dirs in sorted(cases.items()):
        out_dir = os.path.join(args.output, f"vs_gk_{n}")
        logging.info("case %d -> %s", n, out_dir)
        if args.register == "no_registration":
            for tag, ds in (("t1", "T1"), ("t2", "T2")):
                if tag in dirs:
                    convert_case(dirs[tag], out_dir, ds,
                                 roi_pattern=args.roi_pattern)
        else:
            missing = [t for t in ("t1", "t2") if t not in dirs]
            if missing:
                logging.warning("case %d missing %s — skipped", n, missing)
                continue
            _convert_registered(n, dirs, out_dir, args.register,
                                args.roi_pattern)
    return 0


if __name__ == "__main__":
    sys.exit(main())
