"""Convert a .caffemodel into the caffe-layout pickle the weight importer
reads (counterpart of ``squeezedet_tpu/tools/caffemodel2pkl.py``).

    python -m squeezedet_torch.tools.caffemodel2pkl [<prototxt>] \\
        <caffemodel> <out.pkl>

A .caffemodel is a protobuf-encoded ``caffe.NetParameter``; this module
decodes the protobuf *wire format* directly (no caffe, no generated
caffe_pb2, no protoc) into ``{layer_name: [blob0, blob1, ...]}``, the
layout of the reference tool's output (kernels OIHW, biases 1-D for
modern blobs), which ``checkpoint/importer.py`` and
``Detector.load_pretrained`` consume.  The pickle is written with joblib
where it imports, else with the standard ``pickle`` (which the
importer reads too).

Supported container generations (all three caffemodel vintages):
  * V2 ``layer``  (NetParameter field 100, LayerParameter: name=1, blobs=7)
  * V1 ``layers`` (NetParameter field 2, V1LayerParameter: name=4, blobs=6)
  * V0 ``layers`` (same field 2; the connection wraps a V0LayerParameter
    at field 1 with name=1, blobs=50)

Blob shapes mirror caffe's ``Blob::FromProto``: the ``shape`` submessage
(field 7) wins when present; otherwise the legacy num/channels/height/
width fields (1-4) give a 4-D shape, as pycaffe's ``b.data`` reports, so
legacy fc/bias blobs come out (1,1,1,N) here too.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# --- protobuf wire-format primitives -----------------------------------

_VARINT, _FIXED64, _LENGTH, _FIXED32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, payload) records.

    Payload is an int for varints, raw bytes for the other wire types.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == _LENGTH:
            size, pos = _read_varint(buf, pos)
            if pos + size > n:
                raise ValueError("truncated length-delimited field")
            yield field, wire, buf[pos:pos + size]
            pos += size
        elif wire == _FIXED32:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == _FIXED64:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError("unsupported wire type {} (field {})"
                             .format(wire, field))


def _packed_varints(buf: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


# --- caffe message parsers ----------------------------------------------

def _parse_blob(buf: bytes) -> np.ndarray:
    """BlobProto -> ndarray (caffe.proto: data=5 packed float,
    double_data=8, shape=7, legacy num/channels/height/width=1-4)."""
    shape: Optional[List[int]] = None
    legacy = {}
    f32_chunks: List[bytes] = []
    f64_chunks: List[bytes] = []
    for field, wire, val in _iter_fields(buf):
        if field in (1, 2, 3, 4) and wire == _VARINT:
            legacy[field] = val
        elif field == 5:  # repeated float data (packed bytes or one
            f32_chunks.append(val)  # fixed32's raw bytes — both concat)
        elif field == 8:  # repeated double double_data
            f64_chunks.append(val)
        elif field == 7 and wire == _LENGTH:  # BlobShape
            dims: List[int] = []
            for sfield, swire, sval in _iter_fields(val):
                if sfield == 1:
                    if swire == _LENGTH:
                        dims.extend(_packed_varints(sval))
                    else:
                        dims.append(sval)
            shape = dims
        # field 6 (diff) / 9 (double_diff) ignored, like the reference tool
    if f64_chunks:
        data = np.frombuffer(b"".join(f64_chunks), dtype="<f8")
    else:
        data = np.frombuffer(b"".join(f32_chunks), dtype="<f4")
    # Blob::FromProto: legacy dims take precedence when any is present.
    if legacy:
        shape = [legacy.get(1, 0), legacy.get(2, 0),
                 legacy.get(3, 0), legacy.get(4, 0)]
    if shape is None:
        shape = [data.size]
    arr = np.array(data, dtype=data.dtype)  # own the memory
    if int(np.prod(shape)) != arr.size:
        raise ValueError(
            "blob shape {} does not match {} data elements"
            .format(shape, arr.size))
    return arr.reshape(shape)


def _parse_string(val: object) -> str:
    return val.decode("utf-8") if isinstance(val, bytes) else str(val)


def _parse_v0_layer(buf: bytes) -> Tuple[str, List[np.ndarray]]:
    """V0LayerParameter: name=1, blobs=50."""
    name = ""
    blobs: List[np.ndarray] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _LENGTH:
            name = _parse_string(val)
        elif field == 50 and wire == _LENGTH:
            blobs.append(_parse_blob(val))
    return name, blobs


def _parse_v1_layer(buf: bytes) -> Tuple[str, List[np.ndarray]]:
    """V1LayerParameter (name=4, blobs=6) — which doubles as the V0
    connection wrapper (nested V0LayerParameter at field 1)."""
    name = ""
    blobs: List[np.ndarray] = []
    v0: Optional[bytes] = None
    for field, wire, val in _iter_fields(buf):
        if field == 4 and wire == _LENGTH:
            name = _parse_string(val)
        elif field == 6 and wire == _LENGTH:
            blobs.append(_parse_blob(val))
        elif field == 1 and wire == _LENGTH:
            v0 = val
    if not name and not blobs and v0 is not None:
        return _parse_v0_layer(v0)
    return name, blobs


def _parse_v2_layer(buf: bytes) -> Tuple[str, List[np.ndarray]]:
    """LayerParameter: name=1, blobs=7."""
    name = ""
    blobs: List[np.ndarray] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _LENGTH:
            name = _parse_string(val)
        elif field == 7 and wire == _LENGTH:
            blobs.append(_parse_blob(val))
    return name, blobs


def parse_caffemodel(caffemodel_path: str) -> Dict[str, List[np.ndarray]]:
    """Decode NetParameter -> {layer_name: [blob, ...]} in layer order.

    Matches the reference dump (caffemodel2pkl.py:26-29): every layer is
    a key, including parameter-less ones (empty list), keyed by the name
    stored in the caffemodel itself.
    """
    with open(caffemodel_path, "rb") as f:
        buf = f.read()
    weights: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in _iter_fields(buf):
        if wire != _LENGTH:
            continue
        if field == 100:      # repeated LayerParameter layer
            name, blobs = _parse_v2_layer(val)
        elif field == 2:      # repeated V1LayerParameter layers (or V0)
            name, blobs = _parse_v1_layer(val)
        else:
            continue
        if name:
            weights[name] = blobs
    if not weights:
        raise ValueError(
            "{}: no layers found — not a caffemodel NetParameter?"
            .format(caffemodel_path))
    return weights


def dump_caffemodel_weights(prototxt_path: Optional[str],
                            caffemodel_path: str,
                            weights_path: str) -> None:
    """Reference-tool signature (src/utils/caffemodel2pkl.py:20).

    The prototxt is accepted for CLI compatibility but unused: layer
    names come from the caffemodel itself (pycaffe read them from the
    prototxt only because caffe.Net required one to instantiate).
    """
    weights = parse_caffemodel(caffemodel_path)
    try:
        import joblib
    except ImportError:
        import pickle
        with open(weights_path, "wb") as f:
            pickle.dump(weights, f)
        return
    joblib.dump(weights, weights_path)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) == 3:
        dump_caffemodel_weights(*argv)
    elif len(argv) == 2:
        dump_caffemodel_weights(None, argv[0], argv[1])
    else:
        raise SystemExit(
            "Usage: python -m squeezedet_torch.tools.caffemodel2pkl "
            "[<prototxt>] <caffemodel> <out.pkl>")


if __name__ == "__main__":
    main()
