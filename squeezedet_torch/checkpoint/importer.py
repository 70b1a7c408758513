"""Legacy weight import (counterpart of
``squeezedet_tpu/checkpoint/importer.py``): the caffe-derived joblib
pickle, ``{layer_name: [kernel OIHW, bias, ...]}``, which
``Detector.load_pretrained`` maps onto the backbone, and TF1
``model.ckpt-*`` training checkpoints (the reference's released
``model.ckpt-87000``), mapped into the same layout.

The JAX package reads a TF1 checkpoint through TensorFlow; the port
reads the V2 tensor bundle by its wire format (:func:`read_tf_bundle`),
as ``tools/caffemodel2pkl.py`` reads a caffemodel, with numpy alone.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


class TrackedWeights(dict):
    """Pretrained-weight dict that records which entries were read, so a
    cold start can warn about entries that matched no model layer."""

    def __init__(self, data):
        super().__init__(data)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)

    def unconsumed(self):
        return sorted(set(self.keys()) - self.consumed)


def warn_unconsumed(weights) -> List[str]:
    """Print (and return) the entries of a TrackedWeights that no layer
    read: typically a --net mismatch or a naming gap."""
    if not isinstance(weights, TrackedWeights):
        return []
    leftover = weights.unconsumed()
    if leftover:
        print('WARNING: {} pretrained entries matched no model layer and '
              'were ignored: {}'.format(len(leftover), ', '.join(leftover)))
    return leftover


def load_pretrained(path: str) -> Dict[str, List[np.ndarray]]:
    """Load a joblib pickle or a TF1 checkpoint into the caffe layout
    ({name: [kernel OIHW, bias]})."""
    if not path:
        raise ValueError("empty pretrained model path")
    if os.path.exists(path + ".index") or path.endswith(".ckpt") or \
            ".ckpt-" in os.path.basename(path):
        return load_tf1_checkpoint(path)
    try:
        import joblib
        weights = joblib.load(path)
    except ImportError:  # a plain pickle reads without joblib
        import pickle
        with open(path, "rb") as f:
            weights = pickle.load(f)
    return {k: [np.asarray(b) for b in blobs] for k, blobs in weights.items()}


# --- TF V2 tensor bundle (<prefix>.index + <prefix>.data-*), by its
# wire format: the .index file is a LevelDB-style table whose values are
# BundleEntryProto messages, the "" key holding the BundleHeaderProto.

_TABLE_MAGIC = 0xdb4775248b80fb57
_FOOTER_LEN = 48
_BLOCK_TRAILER_LEN = 5  # compression type byte + masked crc32c
# tensorflow DataType -> little-endian numpy dtype; DT_BFLOAT16 (14) is
# widened to float32 exactly, numpy having no bfloat16
_DTYPES = {1: "<f4", 2: "<f8", 3: "<i4", 9: "<i8", 19: "<f2", 14: "<u2"}
_DTYPE_NAMES = {1: "DT_FLOAT", 2: "DT_DOUBLE", 3: "DT_INT32",
                9: "DT_INT64", 19: "DT_HALF", 14: "DT_BFLOAT16"}


def _varint(buf: bytes, pos: int):
    result = shift = 0
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


def _fields(buf: bytes):
    """(field number, wire type, value) of each protobuf field: an int
    for varints and fixed widths, the bytes of a length-delimited one."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            size, pos = _varint(buf, pos)
            if pos + size > len(buf):
                raise ValueError("truncated length-delimited field")
            value, pos = buf[pos:pos + size], pos + size
        elif wire in (1, 5):
            width = 8 if wire == 1 else 4
            value = int.from_bytes(buf[pos:pos + width], "little")
            pos += width
        else:
            raise ValueError("unsupported wire type {}".format(wire))
        yield field, wire, value


def _block(data: bytes, handle: bytes, path: str):
    """The (key, value) entries of the table block at ``handle`` (a
    BlockHandle: varint offset, varint size)."""
    offset, pos = _varint(handle, 0)
    size, _ = _varint(handle, pos)
    if offset + size + _BLOCK_TRAILER_LEN > len(data):
        raise ValueError("{}: block past the end of the file".format(path))
    if data[offset + size] != 0:
        raise ValueError("{}: compressed table block (type {}); only "
                         "uncompressed bundles are read".format(
                             path, data[offset + size]))
    block = data[offset:offset + size]
    if size < 4:
        raise ValueError("{}: block too short".format(path))
    restarts, = np.frombuffer(block[-4:], "<u4")
    end = size - 4 - 4 * int(restarts)  # entries, then the restart array
    entries, pos, key = [], 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        length, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        entries.append((key, block[pos:pos + length]))
        pos += length
    return entries


def _bundle_entries(index_path: str):
    """{tensor name: BundleEntryProto bytes} and the BundleHeaderProto
    bytes of a bundle's .index table."""
    with open(index_path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_LEN or int.from_bytes(
            data[-8:], "little") != _TABLE_MAGIC:
        raise ValueError("{}: not a TF tensor bundle index (bad table "
                         "magic)".format(index_path))
    footer = data[-_FOOTER_LEN:]
    _, pos = _varint(footer, 0)       # metaindex offset
    _, pos = _varint(footer, pos)     # metaindex size
    index_handle = footer[pos:]
    entries, header = {}, None
    for _, handle in _block(data, index_handle, index_path):
        for key, value in _block(data, handle, index_path):
            if key == b"":
                header = value
            else:
                # a sliced variable's slices have binary keys
                entries[key.decode("utf-8", "backslashreplace")] = value
    if header is None:
        raise ValueError("{}: no bundle header".format(index_path))
    return entries, header


def _read_entry(name: str, entry: bytes, shards, path: str) -> np.ndarray:
    dtype = 0
    shape = []
    shard = offset = size = 0
    for field, _, value in _fields(entry):
        if field == 1:
            dtype = value
        elif field == 2:
            for dim_field, _, dim in _fields(value):
                if dim_field == 2:
                    shape.append(next(v for f, _, v in _fields(dim)
                                      if f == 1) if dim else 0)
                elif dim_field == 3 and dim:
                    raise ValueError("{}: {} has an unknown rank".format(
                        path, name))
        elif field == 3:
            shard = value
        elif field == 4:
            offset = value
        elif field == 5:
            size = value
        elif field == 7:
            raise ValueError("{}: {} is saved in slices (a partitioned "
                             "variable), which this reader does not "
                             "join".format(path, name))
    if dtype not in _DTYPES:
        raise ValueError("{}: {} has TF dtype {}; read are {}".format(
            path, name, dtype, ", ".join(_DTYPE_NAMES.values())))
    count = int(np.prod(shape, dtype=np.int64))
    itemsize = np.dtype(_DTYPES[dtype]).itemsize
    if size != count * itemsize:
        raise ValueError("{}: {} holds {} bytes, but {} {} x {} needs "
                         "{}".format(path, name, size, _DTYPE_NAMES[dtype],
                                     shape, count, count * itemsize))
    if shard >= len(shards):
        raise ValueError("{}: {} lies in shard {} of {}".format(
            path, name, shard, len(shards)))
    f = shards[shard]
    f.seek(offset)
    raw = f.read(size)
    if len(raw) != size:
        raise ValueError("{}: {} runs past the end of its data file".format(
            path, name))
    arr = np.frombuffer(raw, _DTYPES[dtype]).reshape(shape)
    if dtype == 14:  # bfloat16: the top half of a float32
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return np.array(arr, dtype=arr.dtype.newbyteorder("="))


def read_tf_bundle(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the TF V2 checkpoint ``path`` (a prefix, as
    ``tf.train.Saver`` names it): {variable name: numpy array}.

    Reads ``<path>.index`` and its ``<path>.data-NNNNN-of-MMMMM`` shards
    without TensorFlow.  Refused, with a message: a V1 checkpoint (one
    file, no ``.index``), compressed index blocks, sliced (partitioned)
    entries, big-endian bundles and dtypes other than float32/64,
    int32/64, float16 and bfloat16 (which is returned widened to
    float32).
    """
    index = path + ".index"
    if not os.path.exists(index):
        if os.path.isfile(path):
            raise ValueError(
                "{}: a TF V1 checkpoint (one file, no .index); read are V2 "
                "bundles, which TF writes by default since 1.0: re-save it "
                "with tf.compat.v1.train.Saver".format(path))
        raise FileNotFoundError("{}: no such checkpoint".format(index))
    entries, header = _bundle_entries(index)
    fields = {f: v for f, _, v in _fields(header)}
    num_shards, endianness = fields.get(1, 1), fields.get(2, 0)
    if endianness != 0:
        raise ValueError("{}: a big-endian bundle".format(path))
    names = ["{}.data-{:05d}-of-{:05d}".format(path, i, num_shards)
             for i in range(num_shards)]
    shards = [open(n, "rb") for n in names]
    try:
        return {name: _read_entry(name, entry, shards, path)
                for name, entry in entries.items()}
    finally:
        for f in shards:
            f.close()


def load_tf1_checkpoint(path: str) -> Dict[str, List[np.ndarray]]:
    """Read a TF1 Saver checkpoint (:func:`read_tf_bundle`) and map it into
    the caffe-pickle layout, as the JAX package's importer does.

    Variable naming contract (the reference's nn_skeleton):
      conv layers:   '<name>/kernels' (HWIO), '<name>/biases'
      conv_bn:       '<conv>/kernels', '<conv>/gamma', '<conv>/beta',
                     '<conv>/mean', '<conv>/var', all five under the
                     *conv* scope.
    """
    tensors = read_tf_bundle(path)
    out: Dict[str, List[np.ndarray]] = {}
    bn_parts: Dict[str, Dict[str, np.ndarray]] = {}
    unmapped = []
    for var, value in tensors.items():
        scope, _, leaf = var.rpartition("/")
        if leaf == "kernels":
            out.setdefault(scope, [None, None])[0] = \
                np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
        elif leaf == "biases":
            out.setdefault(scope, [None, None])[1] = value
        elif leaf in ("gamma", "beta", "mean", "var"):
            bn_parts.setdefault(scope, {})[leaf] = value
        elif leaf != "Momentum" and var not in ("global_step", "iou"):
            # beyond the known optimizer and bookkeeping slots, a name
            # outside the contract is a weight the mapping would drop
            unmapped.append(var)
    if unmapped:
        print('WARNING: {} checkpoint variables do not follow the '
              'kernels/biases/BN naming contract and were dropped: '
              '{}'.format(len(unmapped), ', '.join(sorted(unmapped))))

    # the BN pieces in the pickle layout: bn<stem> = [mean, var] and
    # scale<stem> = [gamma, beta], the stem from the conv scope
    # (res2a_branch1 -> bn2a_branch1, scale2a_branch1)
    for scope, parts in bn_parts.items():
        if not {"mean", "var", "gamma", "beta"} <= set(parts):
            print('WARNING: incomplete batch-norm group at scope {!r} '
                  '(found only {}); its weights were dropped'.format(
                      scope, sorted(parts)))
            continue
        stem = scope[len("res"):] if scope.startswith("res") else \
            "_" + scope
        out["bn" + stem] = [parts["mean"], parts["var"]]
        out["scale" + stem] = [parts["gamma"], parts["beta"]]

    cleaned = {}
    for name, blobs in out.items():
        blobs = [b for b in blobs if b is not None]
        if blobs:
            cleaned[name] = [np.asarray(b) for b in blobs]
    return cleaned
