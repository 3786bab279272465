"""Minimal GLB (binary glTF 2.0) and PLY mesh IO, and surface sampling.

A copy of `labelany3d_tpu/data/meshio.py`:

  * GLB read: POSITION + indices (+ COLOR_0 / TEXCOORD_0 and the material's
    baseColor texture) of every mesh primitive, node transforms applied; a
    textured primitive without COLOR_0 gets vertex colours sampled from its
    own texture, so UV-unaware consumers (the registration renderer) keep
    its appearance;
  * GLB write: one triangle mesh with optional vertex colours and an
    optional UV-mapped texture (TEXCOORD_0 + an embedded PNG baseColor, as
    TRELLIS's `to_glb` writes), the PNG through `utils/png.py`;
  * binary little-endian PLY point clouds and triangle meshes (the depth
    stage's scene PLYs), byte for byte as the JAX package writes them;
  * area-weighted surface sampling (trimesh.sample equivalent).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

import numpy as np

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_SIZES = {5120: 1, 5121: 1, 5122: 2, 5123: 2, 5125: 4, 5126: 4}
_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class Mesh:
    vertices: np.ndarray                       # (V, 3) float32
    faces: np.ndarray                          # (F, 3) int32
    colors: np.ndarray | None = None           # (V, 3|4) uint8 or float
    uv: np.ndarray | None = None               # (V, 2) float32 in [0, 1]
    texture: np.ndarray | None = None          # (H, W, 3) uint8 RGB atlas
    metadata: dict = field(default_factory=dict)

    def apply_transform(self, matrix: np.ndarray) -> "Mesh":
        """4x4 homogeneous transform applied in place; returns self."""
        m = np.asarray(matrix, np.float64)
        self.vertices = (self.vertices @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        return self

    @property
    def is_empty(self) -> bool:
        return self.vertices.size == 0 or self.faces.size == 0

    def face_areas(self) -> np.ndarray:
        tri = self.vertices[self.faces]
        return 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)

    def sample(self, count: int, seed: int = 0) -> np.ndarray:
        """Area-weighted surface sampling, the same numpy draws as the JAX
        package's `Mesh.sample`."""
        areas = self.face_areas()
        total = areas.sum()
        rng = np.random.default_rng(seed)
        if total <= 0:
            idx = rng.integers(0, len(self.vertices), count)
            return self.vertices[idx].astype(np.float32)
        fidx = rng.choice(len(self.faces), size=count, p=areas / total)
        tri = self.vertices[self.faces[fidx]]
        u = rng.uniform(size=(count, 1))
        v = rng.uniform(size=(count, 1))
        flip = (u + v) > 1.0
        u = np.where(flip, 1.0 - u, u)
        v = np.where(flip, 1.0 - v, v)
        return (tri[:, 0] + u * (tri[:, 1] - tri[:, 0])
                + v * (tri[:, 2] - tri[:, 0])).astype(np.float32)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:  # xyzw quaternion
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _read_accessor(gltf: dict, binary: bytes, accessor_idx: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    count = acc["count"]
    stride = view.get("byteStride")
    if stride and stride != _COMPONENT_SIZES[acc["componentType"]] * ncomp:
        data = np.stack([np.frombuffer(binary, dtype, ncomp, offset + i * stride)
                         for i in range(count)])
    else:
        data = np.frombuffer(binary, dtype, count * ncomp, offset).reshape(count, ncomp)
    return data.copy()


def _decode_image(data: bytes) -> np.ndarray:
    """A GLB image's bytes -> (H, W, 3) uint8: PNG through `utils/png.py`,
    any other format through Pillow."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        from labelany3d_tpu_torch.utils.png import decode_png

        img = decode_png(data)
        img = img[..., None] if img.ndim == 2 else img
        if img.shape[-1] in (1, 2):  # gray (+ alpha)
            return np.repeat(img[..., :1], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def load_glb(path) -> Mesh:
    """Load the merged triangle geometry of a GLB file, with vertex colours,
    and the UVs and texture when every textured primitive shares one."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, _version, _length = struct.unpack_from("<III", raw, 0)
    if magic != _GLB_MAGIC:
        raise ValueError(f"Not a GLB file: {path}")
    offset = 12
    gltf = None
    binary = b""
    while offset < len(raw):
        clen, ctype = struct.unpack_from("<II", raw, offset)
        payload = raw[offset + 8:offset + 8 + clen]
        if ctype == _CHUNK_JSON:
            gltf = json.loads(payload)
        elif ctype == _CHUNK_BIN:
            binary = payload
        offset += 8 + clen
    if gltf is None:
        raise ValueError("GLB missing JSON chunk")

    def material_texture(mat_idx) -> np.ndarray | None:
        """The material's embedded baseColor image, if any."""
        pbr = gltf.get("materials", [])[mat_idx].get("pbrMetallicRoughness", {})
        tex_info = pbr.get("baseColorTexture")
        if tex_info is None:
            return None
        img = gltf.get("images", [])[gltf.get("textures", [])[tex_info["index"]]["source"]]
        if "bufferView" not in img:
            return None
        view = gltf["bufferViews"][img["bufferView"]]
        start = view.get("byteOffset", 0)
        return _decode_image(binary[start:start + view["byteLength"]])

    # Textures are kept per material: a primitive samples only its own.
    all_v, all_f, all_c, all_uv, all_mat = [], [], [], [], []
    tex_cache: dict[int, np.ndarray | None] = {}
    vcount = 0

    def visit(node_idx: int, parent: np.ndarray):
        nonlocal vcount
        node = gltf["nodes"][node_idx]
        m = parent @ _node_matrix(node)
        for prim in gltf["meshes"][node["mesh"]]["primitives"] if "mesh" in node else []:
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = _read_accessor(gltf, binary, attrs["POSITION"]).astype(np.float64)
            pos = pos @ m[:3, :3].T + m[:3, 3]
            if "indices" in prim:
                idx = _read_accessor(gltf, binary, prim["indices"]).reshape(-1, 3)
            else:
                idx = np.arange(len(pos)).reshape(-1, 3)
            uv, mat_idx = None, prim.get("material")
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(gltf, binary, attrs["TEXCOORD_0"])
                if mat_idx is not None and mat_idx not in tex_cache:
                    tex_cache[mat_idx] = material_texture(mat_idx)
            all_v.append(pos.astype(np.float32))
            all_f.append(idx.astype(np.int64) + vcount)
            all_c.append(_read_accessor(gltf, binary, attrs["COLOR_0"])
                         if "COLOR_0" in attrs else None)
            all_uv.append(uv)
            all_mat.append(mat_idx)
            vcount += len(pos)
        for child in node.get("children", []):
            visit(child, m)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for r in scene.get("nodes", list(range(len(gltf.get("nodes", []))))):
        visit(r, np.eye(4))
    if not all_v:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    colors = None
    if all(c is not None for c in all_c):
        colors = np.concatenate(all_c, axis=0)
    uv = None
    if all(u is not None for u in all_uv):
        uv = np.concatenate(all_uv, axis=0).astype(np.float32)
    # The merged (uv, texture) pair only means something when every textured
    # primitive references the same atlas.
    tex_mats = {m for m, u in zip(all_mat, all_uv)
                if u is not None and tex_cache.get(m) is not None}
    texture = tex_cache[next(iter(tex_mats))] if len(tex_mats) == 1 and uv is not None else None

    def sample(tex, puv):
        th, tw = tex.shape[:2]
        ui = np.clip((puv[:, 0] % 1.0) * (tw - 1), 0, tw - 1).astype(np.int64)
        vi = np.clip((puv[:, 1] % 1.0) * (th - 1), 0, th - 1).astype(np.int64)
        return tex[vi, ui].astype(np.float32) / 255.0

    if colors is None and tex_mats:
        # Per primitive: its COLOR_0, else its own texture sampled; primitives
        # with neither are grey when several atlases exist, else no colours.
        per_prim = []
        for pv, pc, puv, pm in zip(all_v, all_c, all_uv, all_mat):
            if pc is not None:
                per_prim.append(np.asarray(pc, np.float32)[:, :3])
            elif puv is not None and tex_cache.get(pm) is not None:
                per_prim.append(sample(tex_cache[pm], puv))
            elif len(tex_mats) > 1:
                per_prim.append(np.full((len(pv), 3), 0.5, np.float32))
            else:
                per_prim = None
                break
        if per_prim is not None:
            colors = np.concatenate(per_prim, axis=0)
    return Mesh(vertices=np.concatenate(all_v, axis=0),
                faces=np.concatenate(all_f, axis=0).astype(np.int32), colors=colors,
                uv=uv, texture=texture)


def save_glb(path, mesh: Mesh) -> None:
    """Write one triangle mesh as a GLB (positions, indices, optional vertex
    colours, optional TEXCOORD_0 + embedded PNG baseColor texture). Without a
    texture it is byte for byte the JAX package's file; with one, the JSON
    and geometry are, and the PNG is this package's encoding of the same
    pixels."""
    v = np.ascontiguousarray(mesh.vertices, np.float32)
    f = np.ascontiguousarray(mesh.faces, np.uint32).reshape(-1, 3)
    buffers = [v.tobytes(), f.tobytes()]
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": len(buffers[0]), "target": 34962},
        {"buffer": 0, "byteOffset": len(buffers[0]), "byteLength": len(buffers[1]),
         "target": 34963},
    ]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": len(v), "type": "VEC3",
         "min": v.min(axis=0).tolist() if len(v) else [0, 0, 0],
         "max": v.max(axis=0).tolist() if len(v) else [0, 0, 0]},
        {"bufferView": 1, "componentType": 5125, "count": f.size, "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}
    if mesh.colors is not None:
        c = np.ascontiguousarray(mesh.colors, np.float32)
        off = sum(len(b) for b in buffers)
        buffers.append(c.tobytes())
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(buffers[-1]),
                      "target": 34962})
        accessors.append({"bufferView": len(views) - 1, "componentType": 5126,
                          "count": len(c), "type": "VEC3" if c.shape[1] == 3 else "VEC4"})
        attributes["COLOR_0"] = len(accessors) - 1

    gltf_extra: dict = {}
    primitive: dict = {"attributes": attributes, "indices": 1, "mode": 4}
    if mesh.uv is not None and mesh.texture is not None:
        from labelany3d_tpu_torch.utils.png import encode_png

        uv = np.ascontiguousarray(mesh.uv, np.float32).reshape(-1, 2)
        if len(uv) != len(v):
            raise ValueError(f"uv must be per-vertex: {len(uv)} uvs for {len(v)} vertices")
        off = sum(len(b) for b in buffers)
        buffers.append(uv.tobytes())
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(buffers[-1]),
                      "target": 34962})
        accessors.append({"bufferView": len(views) - 1, "componentType": 5126,
                          "count": len(uv), "type": "VEC2"})
        attributes["TEXCOORD_0"] = len(accessors) - 1
        png = encode_png(np.ascontiguousarray(mesh.texture, np.uint8))
        off = sum(len(b) for b in buffers)
        pad = (-off) % 4  # an image's bufferView must be 4-aligned
        if pad:
            buffers.append(b"\x00" * pad)
            off += pad
        buffers.append(png)
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(png)})
        gltf_extra = {
            "images": [{"bufferView": len(views) - 1, "mimeType": "image/png"}],
            "samplers": [{"magFilter": 9729, "minFilter": 9729, "wrapS": 10497,
                          "wrapT": 10497}],
            "textures": [{"sampler": 0, "source": 0}],
            "materials": [{"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0, "texCoord": 0},
                "metallicFactor": 0.0, "roughnessFactor": 1.0}, "doubleSided": True}],
        }
        primitive["material"] = 0

    bin_blob = b"".join(buffers)
    bin_blob += b"\x00" * ((-len(bin_blob)) % 4)
    gltf = {
        "asset": {"version": "2.0", "generator": "labelany3d_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [primitive]}],
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": views,
        "accessors": accessors,
        **gltf_extra,
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_blob)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        fh.write(struct.pack("<II", len(js), _CHUNK_JSON))
        fh.write(js)
        fh.write(struct.pack("<II", len(bin_blob), _CHUNK_BIN))
        fh.write(bin_blob)


def _ply_vertex_header(n: int, colors: np.ndarray | None) -> tuple[list[str], np.ndarray | None]:
    """The vertex element's header lines and the colours as uint8 (clipped
    when given in another dtype)."""
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    return header, colors


def _ply_vertex_bytes(pts: np.ndarray, colors: np.ndarray | None) -> bytes:
    if colors is None:
        return pts.tobytes()
    rec = np.zeros(len(pts), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
    rec["xyz"] = pts
    rec["rgb"] = colors
    return rec.tobytes()


def save_ply_points(path, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY point cloud (`depth_scene.ply`)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    header, colors = _ply_vertex_header(len(pts), colors)
    with open(path, "wb") as f:
        f.write(("\n".join(header + ["end_header"]) + "\n").encode())
        f.write(_ply_vertex_bytes(pts, colors))


def save_ply_mesh(path, vertices: np.ndarray, faces: np.ndarray,
                  colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY triangle mesh (`depth_scene_no_edge.ply`)."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    header, colors = _ply_vertex_header(len(v), colors)
    header += [f"element face {len(f)}", "property list uchar int vertex_indices",
               "end_header"]
    frec = np.zeros(len(f), dtype=[("n", np.uint8), ("idx", np.int32, 3)])
    frec["n"] = 3
    frec["idx"] = f
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode())
        fh.write(_ply_vertex_bytes(v, colors))
        fh.write(frec.tobytes())


def load_ply_points(path) -> tuple[np.ndarray, np.ndarray | None]:
    """The vertices (and colours, if any) of a binary little-endian PLY
    written by `save_ply_points` or `save_ply_mesh`."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode().splitlines()
    n = next(int(line.split()[-1]) for line in header if line.startswith("element vertex"))
    if "property uchar red" in header:
        rec = np.frombuffer(raw, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)],
                            count=n, offset=end)
        return rec["xyz"].copy(), rec["rgb"].copy()
    return np.frombuffer(raw, np.float32, n * 3, end).reshape(n, 3).copy(), None
