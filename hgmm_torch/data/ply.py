"""PLY point-cloud I/O (Stanford scans: bunny/dragon/happy-buddha —
BASELINE.json configs 1-2).

Counterpart of ``hgmm/data/ply.py`` on its pure-numpy path (the JAX
package's native C++ reader is not ported yet). Supports ascii and binary
little- and big-endian files with float/double vertex properties;
non-vertex elements (faces) are skipped.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PLY_DTYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("<u1", 1), "uint8": ("<u1", 1),
    "char": ("<i1", 1), "int8": ("<i1", 1),
    "short": ("<i2", 2), "int16": ("<i2", 2),
    "ushort": ("<u2", 2), "uint16": ("<u2", 2),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
}


def load_ply(path: str | Path, dtype=np.float32) -> np.ndarray:
    """Read vertex x/y/z from a PLY file -> [N, 3] array."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, type_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur[2].append((parts[-1], ("list", parts[2], parts[3])))
                else:
                    cur[2].append((parts[-1], parts[1]))
            elif parts[0] == "end_header":
                break

        for name, count, props in elements:
            if name != "vertex":
                continue
            prop_names = [p[0] for p in props]
            if not all(c in prop_names for c in "xyz"):
                raise ValueError(f"vertex element lacks x/y/z: {prop_names}")
            if fmt == "ascii":
                rows = np.loadtxt(
                    [f.readline() for _ in range(count)], dtype=np.float64
                ).reshape(count, len(props))
                idx = [prop_names.index(c) for c in "xyz"]
                return rows[:, idx].astype(dtype)
            if fmt in ("binary_little_endian", "binary_big_endian"):
                endian = "<" if fmt == "binary_little_endian" else ">"
                np_dtype = np.dtype(
                    [
                        (p, _PLY_DTYPES[t][0].replace("<", endian))
                        for p, t in props
                        if not isinstance(t, tuple)
                    ]
                )
                raw = np.frombuffer(f.read(count * np_dtype.itemsize), dtype=np_dtype)
                return np.stack(
                    [raw["x"], raw["y"], raw["z"]], axis=1
                ).astype(dtype)
            raise ValueError(f"unsupported PLY format {fmt}")
        raise ValueError("no vertex element in PLY")


def save_ply(path: str | Path, points: np.ndarray, binary: bool = True) -> None:
    """Write [N, 3] points as a PLY file."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(points.astype("<f4").tobytes())
        else:
            np.savetxt(f, points, fmt="%.7g")
