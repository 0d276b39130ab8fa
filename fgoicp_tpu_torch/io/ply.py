"""Minimal, dependency-free PLY reader/writer.

Covers what the reference needs from tinyply (reference
src/utilities.hpp:113-179): read float/double x,y,z vertex properties from
ascii and binary_little_endian PLY files; write point clouds back out for
visualization.  Unknown elements and extra properties are skipped.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class PlyError(RuntimeError):
    pass


def _parse_header(f):
    magic = f.readline().strip()
    if magic != b"ply":
        raise PlyError("Not a PLY file (missing 'ply' magic)")
    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype_str, is_list, list_count_dtype)])
    while True:
        line = f.readline()
        if not line:
            raise PlyError("Unexpected EOF in PLY header")
        tokens = line.decode("ascii", errors="replace").strip().split()
        if not tokens:
            continue
        kw = tokens[0]
        if kw == "comment" or kw == "obj_info":
            continue
        if kw == "format":
            fmt = tokens[1]
        elif kw == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif kw == "property":
            if not elements:
                raise PlyError("property before element in PLY header")
            if tokens[1] == "list":
                elements[-1][2].append((tokens[4], _DTYPES[tokens[3]], True, _DTYPES[tokens[2]]))
            else:
                elements[-1][2].append((tokens[2], _DTYPES[tokens[1]], False, None))
        elif kw == "end_header":
            break
        else:
            raise PlyError(f"Unknown PLY header keyword: {kw}")
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise PlyError(f"Unsupported PLY format: {fmt}")
    return fmt, elements


def read_ply_vertices(path: str) -> np.ndarray:
    """Return the vertex element's (x, y, z) as float32 [N, 3]."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = ">" if fmt == "binary_big_endian" else "<"
        vertices = None
        for name, count, props in elements:
            if any(p[2] for p in props):
                if name == "vertex":
                    raise PlyError("list properties on vertex element unsupported")
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    # Variable-size rows: parse one by one.
                    for _ in range(count):
                        for _, dt, is_list, cnt_dt in props:
                            if is_list:
                                n = int(np.frombuffer(f.read(np.dtype(cnt_dt).itemsize), dtype=endian + cnt_dt)[0])
                                f.read(n * np.dtype(dt).itemsize)
                            else:
                                f.read(np.dtype(dt).itemsize)
                continue
            dtype = np.dtype([(p[0], endian + p[1]) for p in props])
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                data = np.array(rows, dtype=np.float64)
                rec = {p[0]: data[:, i] for i, p in enumerate(props)}
            else:
                raw = f.read(count * dtype.itemsize)
                if len(raw) < count * dtype.itemsize:
                    raise PlyError("Unexpected EOF in PLY body")
                arr = np.frombuffer(raw, dtype=dtype, count=count)
                rec = {p[0]: arr[p[0]] for p in props}
            if name == "vertex":
                for k in ("x", "y", "z"):
                    if k not in rec:
                        raise PlyError("PLY file missing 'x', 'y', or 'z' vertex properties.")
                vertices = np.stack(
                    [rec["x"], rec["y"], rec["z"]], axis=1
                ).astype(np.float32)
        if vertices is None:
            raise PlyError("No vertices found in the PLY file.")
        return vertices


def write_ply(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write an [N, 3] float point cloud as a PLY file."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {len(pts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")
