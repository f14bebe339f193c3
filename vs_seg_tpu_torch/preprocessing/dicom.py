"""Minimal DICOM reader (pure Python, no pydicom dependency): the port's
copy of vs_seg_tpu/preprocessing/dicom.py.

Parses the subset of DICOM needed by the preprocessing toolchain (reference
preprocessing/TCIA_data_convert_into_convenient_folder_structure.py uses
pydicom for Modality/UID routing; preprocessing/data_conversion.py reads
geometry + contours through 3D Slicer). Supports Explicit and Implicit VR
Little Endian, nested sequences, and uncompressed pixel data.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np

# Tags we care about (group, element)
TAGS = {
    (0x0008, 0x0016): "SOPClassUID",
    (0x0008, 0x0018): "SOPInstanceUID",
    (0x0008, 0x0060): "Modality",
    (0x0008, 0x103E): "SeriesDescription",
    (0x0010, 0x0010): "PatientName",
    (0x0010, 0x0020): "PatientID",
    (0x0020, 0x000D): "StudyInstanceUID",
    (0x0020, 0x000E): "SeriesInstanceUID",
    (0x0020, 0x0013): "InstanceNumber",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0037): "ImageOrientationPatient",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x0018, 0x0050): "SliceThickness",
    (0x7FE0, 0x0010): "PixelData",
    # RTSTRUCT
    (0x3006, 0x0002): "StructureSetLabel",
    (0x3006, 0x0010): "ReferencedFrameOfReferenceSequence",
    # RT Referenced Study/Series nesting: real TCIA RTSTRUCTs carry the
    # referenced image SeriesInstanceUID inside (0x3006,0x0012)/(0x3006,
    # 0x0014) items — without these names the parser drops the items and
    # RTSS-to-series pairing can never match
    (0x3006, 0x0012): "RTReferencedStudySequence",
    (0x3006, 0x0014): "RTReferencedSeriesSequence",
    (0x3006, 0x0016): "ContourImageSequence",
    (0x3006, 0x0020): "StructureSetROISequence",
    (0x3006, 0x0026): "ROIName",
    (0x3006, 0x0022): "ROINumber",
    (0x3006, 0x0039): "ROIContourSequence",
    (0x3006, 0x0040): "ContourSequence",
    (0x3006, 0x0046): "NumberOfContourPoints",
    (0x3006, 0x0050): "ContourData",
    (0x3006, 0x0084): "ReferencedROINumber",
    (0x3006, 0x0024): "ReferencedFrameOfReferenceUID",
    (0x0008, 0x1155): "ReferencedSOPInstanceUID",
    (0x0020, 0x0052): "FrameOfReferenceUID",
    # RTPLAN -> RTSTRUCT and RTDOSE -> RTPLAN chaining (reference
    # TCIA_data_convert_into_convenient_folder_structure.py:91-120)
    (0x300C, 0x0060): "ReferencedStructureSetSequence",
    (0x300C, 0x0002): "ReferencedRTPlanSequence",
    # BIDS sidecar metadata (reference data_conversion_BIDS.py:385-410 pulls
    # these via pydicom keywords; the non-DICOM BIDS-only names in its tag
    # list are skipped there too — pydicom raises and the except swallows it)
    (0x0008, 0x0008): "ImageType",
    (0x0008, 0x0020): "StudyDate",
    (0x0008, 0x0032): "AcquisitionTime",
    (0x0008, 0x0070): "Manufacturer",
    (0x0008, 0x0080): "InstitutionName",
    (0x0008, 0x0081): "InstitutionAddress",
    (0x0008, 0x1010): "StationName",
    (0x0008, 0x1040): "InstitutionalDepartmentName",
    (0x0008, 0x1090): "ManufacturerModelName",
    (0x0018, 0x0020): "ScanningSequence",
    (0x0018, 0x0021): "SequenceVariant",
    (0x0018, 0x0022): "ScanOptions",
    (0x0018, 0x0023): "MRAcquisitionType",
    (0x0018, 0x0024): "SequenceName",
    (0x0018, 0x0080): "RepetitionTime",
    (0x0018, 0x0081): "EchoTime",
    (0x0018, 0x0082): "InversionTime",
    (0x0018, 0x0084): "ImagingFrequency",
    (0x0018, 0x0087): "MagneticFieldStrength",
    (0x0018, 0x0089): "NumberOfPhaseEncodingSteps",
    (0x0018, 0x0093): "PercentSampling",
    (0x0018, 0x0094): "PercentPhaseFieldOfView",
    (0x0018, 0x0095): "PixelBandwidth",
    (0x0018, 0x1000): "DeviceSerialNumber",
    (0x0018, 0x1020): "SoftwareVersions",
    (0x0018, 0x1030): "ProtocolName",
    (0x0018, 0x1048): "ContrastBolusIngredient",
    (0x0018, 0x1250): "ReceiveCoilName",
    (0x0018, 0x1251): "TransmitCoilName",
    (0x0018, 0x1312): "InPlanePhaseEncodingDirection",
    (0x0018, 0x1314): "FlipAngle",
    (0x0018, 0x1316): "SAR",
    (0x0018, 0x5100): "PatientPosition",
    (0x0018, 0x9036): "PartialFourierDirection",
    (0x0018, 0x9069): "ParallelReductionFactorInPlane",
    (0x0018, 0x9078): "ParallelAcquisitionTechnique",
    (0x0018, 0x9081): "PartialFourier",
    (0x0020, 0x0011): "SeriesNumber",
    (0x0020, 0x0012): "AcquisitionNumber",
    (0x0040, 0x0254): "PerformedProcedureStepDescription",
    # participants.tsv demographics (reference hardcodes its 242 rows at
    # data_conversion_BIDS.py:520-...; we extract from DICOM when present)
    (0x0010, 0x0040): "PatientSex",
    (0x0010, 0x1010): "PatientAge",
}

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR", b"UT", b"UN"}
_NUMERIC_VRS = {b"DS", b"IS"}
_BINARY_INT_VRS = {b"US": "<H", b"SS": "<h", b"UL": "<I", b"SL": "<i"}
_FLOAT_VRS = {b"FL": "<f", b"FD": "<d"}


class DicomDataset(dict):
    """Parsed DICOM elements keyed by friendly name (TAGS) and raw tag."""

    def get_first(self, name: str, default=None):
        v = self.get(name, default)
        if isinstance(v, list) and v:
            return v[0]
        return v


def _decode_value(vr: bytes, payload: bytes):
    if vr in _BINARY_INT_VRS:
        fmt = _BINARY_INT_VRS[vr]
        n = len(payload) // struct.calcsize(fmt)
        vals = list(struct.unpack("<" + fmt[1] * n, payload))
        return vals if len(vals) != 1 else vals[0]
    if vr in _FLOAT_VRS:
        fmt = _FLOAT_VRS[vr]
        n = len(payload) // struct.calcsize(fmt)
        vals = list(struct.unpack("<" + fmt[1] * n, payload))
        return vals if len(vals) != 1 else vals[0]
    text = payload.decode("latin-1", errors="replace").strip("\x00 ")
    if vr in _NUMERIC_VRS:
        parts = [p for p in text.split("\\") if p.strip()]
        try:
            vals = [float(p) for p in parts]
        except ValueError:
            return text
        return vals if len(vals) != 1 else vals[0]
    if "\\" in text:
        return text.split("\\")
    return text


def _parse_elements(buf: bytes, pos: int, end: int, implicit: bool,
                    stop_at_pixel_data: bool = False) -> (Dict, int):
    ds = DicomDataset()
    while pos + 8 <= end:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        tag = (group, elem)
        if tag == (0xFFFE, 0xE00D) or tag == (0xFFFE, 0xE0DD):  # item/seq delimiter
            pos += 4
            break
        if implicit or tag[0] == 0xFFFE:
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            vr = b"UN"
        else:
            vr = buf[pos:pos + 2]
            pos += 2
            if vr in _EXPLICIT_LONG_VRS:
                pos += 2  # reserved
                (length,) = struct.unpack_from("<I", buf, pos)
                pos += 4
            else:
                (length,) = struct.unpack_from("<H", buf, pos)
                pos += 2

        is_sq = (vr == b"SQ") or (implicit and length == 0xFFFFFFFF and tag != (0x7FE0, 0x0010))
        name = TAGS.get(tag)

        if is_sq or (implicit and name and name.endswith("Sequence")):
            items = []
            if length == 0xFFFFFFFF:
                # undefined length: parse items until sequence delimiter
                while pos + 8 <= end:
                    itag = struct.unpack_from("<HH", buf, pos)
                    (ilen,) = struct.unpack_from("<I", buf, pos + 4)
                    pos += 8
                    if itag == (0xFFFE, 0xE0DD):
                        break
                    if itag != (0xFFFE, 0xE000):
                        break
                    item_end = end if ilen == 0xFFFFFFFF else pos + ilen
                    item, pos = _parse_elements(buf, pos, item_end, implicit)
                    items.append(item)
            else:
                seq_end = pos + length
                while pos + 8 <= seq_end:
                    itag = struct.unpack_from("<HH", buf, pos)
                    (ilen,) = struct.unpack_from("<I", buf, pos + 4)
                    pos += 8
                    if itag != (0xFFFE, 0xE000):
                        break
                    item_end = seq_end if ilen == 0xFFFFFFFF else pos + ilen
                    item, pos = _parse_elements(buf, pos, item_end, implicit)
                    items.append(item)
                pos = seq_end
            if name:
                ds[name] = items
            continue

        if length == 0xFFFFFFFF:
            raise ValueError(f"undefined-length non-sequence element {tag}")
        payload = buf[pos:pos + length]
        pos += length
        if tag == (0x7FE0, 0x0010):
            ds["PixelData"] = payload
            if stop_at_pixel_data:
                return ds, pos
            continue
        if name:
            ds[name] = _decode_value(vr if not implicit else _guess_vr(name), payload)
    return ds, pos


def _guess_vr(name: str) -> bytes:
    if name in ("Rows", "Columns", "BitsAllocated", "PixelRepresentation"):
        return b"US"
    if name in ("ImagePositionPatient", "ImageOrientationPatient", "PixelSpacing",
                "RescaleIntercept", "RescaleSlope", "SliceThickness",
                "ContourData", "NumberOfContourPoints", "InstanceNumber",
                "ROINumber", "ReferencedROINumber", "RepetitionTime",
                "EchoTime", "InversionTime", "ImagingFrequency",
                "MagneticFieldStrength", "NumberOfPhaseEncodingSteps",
                "PercentSampling", "PercentPhaseFieldOfView", "PixelBandwidth",
                "FlipAngle", "SAR", "SeriesNumber", "AcquisitionNumber"):
        return b"DS"
    return b"LO"


def read_dicom(path: str, headers_only: bool = False) -> DicomDataset:
    """Parse a DICOM file. `headers_only` stops at PixelData — routing /
    classification passes over multi-GB downloads don't need the payloads."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 132 or buf[128:132] != b"DICM":
        # some files lack the preamble; try parsing from 0 as implicit VR
        ds, _ = _parse_elements(buf, 0, len(buf), implicit=True,
                                stop_at_pixel_data=headers_only)
        return ds
    # file meta info (group 0002) is always explicit VR little endian
    meta, pos = _parse_file_meta(buf, 132)
    tsuid = meta.get("TransferSyntaxUID", "1.2.840.10008.1.2.1")
    if tsuid == "1.2.840.10008.1.2":
        implicit = True
    elif tsuid in ("1.2.840.10008.1.2.1", "1.2.840.10008.1.2.1.99"):
        implicit = False
    else:
        # compressed transfer syntaxes unsupported; parse headers anyway
        implicit = False
    ds, _ = _parse_elements(buf, pos, len(buf), implicit,
                            stop_at_pixel_data=headers_only)
    ds["TransferSyntaxUID"] = tsuid
    return ds


def _parse_file_meta(buf: bytes, pos: int):
    meta: Dict[str, Any] = {}
    # (0002,0000) UL group length
    group, elem = struct.unpack_from("<HH", buf, pos)
    if (group, elem) != (0x0002, 0x0000):
        return meta, pos
    vr = buf[pos + 4:pos + 6]
    (length,) = struct.unpack_from("<H", buf, pos + 6)
    (group_len,) = struct.unpack_from("<I", buf, pos + 8)
    pos += 12
    end = pos + group_len
    while pos + 8 <= end:
        group, elem = struct.unpack_from("<HH", buf, pos)
        vr = buf[pos + 4:pos + 6]
        if vr in _EXPLICIT_LONG_VRS:
            (length,) = struct.unpack_from("<I", buf, pos + 8)
            pos += 12
        else:
            (length,) = struct.unpack_from("<H", buf, pos + 6)
            pos += 8
        payload = buf[pos:pos + length]
        pos += length
        if (group, elem) == (0x0002, 0x0010):
            meta["TransferSyntaxUID"] = payload.decode("ascii").strip("\x00 ")
    return meta, end


def pixel_array(ds: DicomDataset) -> np.ndarray:
    """Decode uncompressed PixelData into (Rows, Columns)."""
    rows, cols = int(ds["Rows"]), int(ds["Columns"])
    bits = int(ds.get("BitsAllocated", 16))
    signed = int(ds.get("PixelRepresentation", 0)) == 1
    if bits == 16:
        dtype = np.int16 if signed else np.uint16
    elif bits == 8:
        dtype = np.int8 if signed else np.uint8
    else:
        raise ValueError(f"unsupported BitsAllocated {bits}")
    arr = np.frombuffer(ds["PixelData"], dtype=dtype, count=rows * cols)
    return arr.reshape(rows, cols)
