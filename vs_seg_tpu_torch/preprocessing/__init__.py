"""The offline preprocessing toolchain (TCIA DICOM -> case folders ->
NIFTI -> BIDS): the port's copy of vs_seg_tpu/preprocessing/, numpy and
scipy only. Run it as `python -m vs_seg_tpu_torch.preprocessing
{restructure,convert,bids}` (__main__.py)."""

from vs_seg_tpu_torch.preprocessing.dicom import read_dicom, pixel_array
from vs_seg_tpu_torch.preprocessing.convert import (
    load_series, rasterize_contours, extract_rtstruct_contours,
    restructure_tcia, convert_case, load_contours_json,
)
from vs_seg_tpu_torch.preprocessing.registration import read_itk_tfm, resample_to_reference
from vs_seg_tpu_torch.preprocessing.bids import build_bids_dataset, bids_path
