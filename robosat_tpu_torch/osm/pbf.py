"""Streaming OpenStreetMap .osm.pbf reader (pure Python, stdlib only).

This package's copy of robosat_tpu/osm/pbf.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_osm.py.

Replaces pyosmium/libosmium (reference: robosat/tools/extract.py:29,
robosat/osm/*.py SimpleHandler) with a self-contained protobuf wire-format
decoder for the OSM PBF fileformat:

  file    := (int32-be header_len, BlobHeader, Blob)*
  Blob    := raw bytes | zlib-compressed PrimitiveBlock
  block   := stringtable + primitive groups of dense nodes / ways / relations

Only the subset the pipeline needs is decoded: dense node locations, ways
with tags and node refs. Handlers receive `Way` objects mirroring the osmium
API surface the reference handlers use (`w.id`, `w.tags`, `w.nodes` with
`.lon`/`.lat`, `w.is_closed()`).

Also reads plain .osm XML for small extracts.
"""

import struct
import zlib


# ---------------------------------------------------------------- wire format

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(n):
    return (n >> 1) ^ -(n & 1)


def _iter_fields(buf):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError("unsupported wire type {}".format(wire))
        yield field, wire, value


def _packed_varints(buf, signed=False):
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_zigzag(v) if signed else v)
    return out


# ------------------------------------------------------------------- entities

class Node:
    __slots__ = ("ref", "lon", "lat")

    def __init__(self, ref, lon, lat):
        self.ref = ref
        self.lon = lon
        self.lat = lat


class Way:
    __slots__ = ("id", "tags", "nodes")

    def __init__(self, wid, tags, nodes):
        self.id = wid
        self.tags = tags
        self.nodes = nodes

    def is_closed(self):
        return len(self.nodes) >= 2 and self.nodes[0].ref == self.nodes[-1].ref


# ------------------------------------------------------------------ pbf parse

def _iter_blobs(fp):
    while True:
        header_len_bytes = fp.read(4)
        if len(header_len_bytes) < 4:
            return
        (header_len,) = struct.unpack(">i", header_len_bytes)
        header = fp.read(header_len)

        blob_type = None
        datasize = 0
        for field, _, value in _iter_fields(header):
            if field == 1:
                blob_type = value.decode()
            elif field == 3:
                datasize = value

        blob = fp.read(datasize)
        raw = None
        for field, _, value in _iter_fields(blob):
            if field == 1:  # raw
                raw = value
            elif field == 3:  # zlib_data
                raw = zlib.decompress(value)
        yield blob_type, raw


def _parse_string_table(buf):
    return [value.decode("utf-8", "replace") for field, _, value in _iter_fields(buf) if field == 1]


def _parse_dense_nodes(buf, strings, gran, lat_off, lon_off, locations):
    ids = lats = lons = None
    for field, _, value in _iter_fields(buf):
        if field == 1:
            ids = _packed_varints(value, signed=True)
        elif field == 8:
            lats = _packed_varints(value, signed=True)
        elif field == 9:
            lons = _packed_varints(value, signed=True)
    if not ids:
        return
    ref = lat = lon = 0
    for dref, dlat, dlon in zip(ids, lats, lons):
        ref += dref
        lat += dlat
        lon += dlon
        locations[ref] = (
            1e-9 * (lon_off + gran * lon),
            1e-9 * (lat_off + gran * lat),
        )


def _parse_plain_node(buf, strings, gran, lat_off, lon_off, locations):
    ref = lat = lon = 0
    for field, _, value in _iter_fields(buf):
        if field == 1:  # Node.id, sint64
            ref = _zigzag(value)
        elif field == 8:  # Node.lat, sint64
            lat = _zigzag(value)
        elif field == 9:  # Node.lon, sint64
            lon = _zigzag(value)
    locations[ref] = (1e-9 * (lon_off + gran * lon), 1e-9 * (lat_off + gran * lat))


def _parse_way(buf, strings, locations):
    wid = 0
    keys = vals = refs = []
    for field, _, value in _iter_fields(buf):
        if field == 1:
            wid = value
        elif field == 2:
            keys = _packed_varints(value)
        elif field == 3:
            vals = _packed_varints(value)
        elif field == 8:
            refs = _packed_varints(value, signed=True)

    tags = {strings[k]: strings[v] for k, v in zip(keys, vals)}

    nodes = []
    ref = 0
    for dref in refs:
        ref += dref
        lon, lat = locations.get(ref, (None, None))
        nodes.append(Node(ref, lon, lat))
    return Way(wid, tags, nodes)


def iter_pbf_ways(path):
    """Stream Way objects (with node locations resolved) from an .osm.pbf.

    Nodes precede ways in standard OSM PBF ordering, so a single pass keeps a
    node-location map and resolves way geometry on the fly.
    """
    locations = {}
    with open(path, "rb") as fp:
        for blob_type, raw in _iter_blobs(fp):
            if blob_type != "OSMData" or raw is None:
                continue

            strings = []
            groups = []
            gran, lat_off, lon_off = 100, 0, 0
            for field, _, value in _iter_fields(raw):
                if field == 1:
                    strings = _parse_string_table(value)
                elif field == 2:
                    groups.append(value)
                elif field == 17:
                    gran = value
                elif field == 19:
                    lat_off = value
                elif field == 20:
                    lon_off = value

            for group in groups:
                for field, _, value in _iter_fields(group):
                    if field == 1:  # plain nodes
                        _parse_plain_node(value, strings, gran, lat_off, lon_off, locations)
                    elif field == 2:  # dense nodes
                        _parse_dense_nodes(value, strings, gran, lat_off, lon_off, locations)
                    elif field == 3:  # ways
                        yield _parse_way(value, strings, locations)


def iter_xml_ways(path):
    """Stream Way objects from a plain .osm XML file (small extracts)."""
    import xml.etree.ElementTree as ET

    locations = {}
    ways = []
    for _, elem in ET.iterparse(path, events=("end",)):
        if elem.tag == "node":
            locations[int(elem.get("id"))] = (float(elem.get("lon")), float(elem.get("lat")))
        elif elem.tag == "way":
            tags = {t.get("k"): t.get("v") for t in elem.findall("tag")}
            refs = [int(nd.get("ref")) for nd in elem.findall("nd")]
            ways.append((int(elem.get("id")), tags, refs))
        if elem.tag in ("node", "way", "relation"):
            elem.clear()

    for wid, tags, refs in ways:
        nodes = []
        for ref in refs:
            lon, lat = locations.get(ref, (None, None))
            nodes.append(Node(ref, lon, lat))
        yield Way(wid, tags, nodes)


def iter_ways(path):
    """Stream ways from .osm.pbf or .osm/.xml based on the file extension."""
    if path.endswith(".pbf"):
        return iter_pbf_ways(path)
    return iter_xml_ways(path)


class SimpleHandler:
    """Base class mirroring osmium.SimpleHandler's `way` callback contract."""

    def way(self, w):  # pragma: no cover - overridden by subclasses
        pass

    def apply_file(self, filename, locations=True):
        for w in iter_ways(filename):
            self.way(w)
