"""JSON scene loading -> frozen SoA pytree of device arrays.

Parity: reference src/core/scene.cpp (JSON schema, material/light/camera
construction, pattern parsing, clamping quirks).  Instead of virtual Material
/Pattern/Light objects, everything is baked into data:

  * triangles: one concatenated SoA soup with a per-triangle mesh id
  * materials: per-mesh parameter tables; every pattern is either a constant
    or an index into one packed flat texture buffer (per-hit gather)
  * lights: a small static list of LightData records (unrolled in jit)
  * camera/medium: plain records

Matrix convention: JSON 4x4s are row-major matrices A acting on column
vectors (points A @ [p,1], directions A @ [d,0], normals inv(A).T @ [n,0]) —
equivalent to the reference's GLM row-vector expressions (scene.cpp:64-75,
240-254; pinholecamera.cpp:32-33).

Reference quirks consciously preserved (SURVEY.md "behavioral quirks"):
  * bare-array rho_d is NOT clamped to <1; all other color constants are
    clamped per channel to 1 - epsilon (scene.cpp:345-590)
  * glass materials never get normal maps (GlassMaterial ctor self-move bug,
    glassmaterial.cpp:4-9)
  * "distant" lights are not constructible from JSON (scene.cpp:894-923)
  * disk lights ignore "innerRadius" (only rings use it)
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .tree import pytree_dataclass
from . import geo as geo_mod
from . import exr as exr_mod
from . import vol as vol_mod

FLT_BEFORE_ONE = np.float32(1.0) - np.float32(1.1920928955078125e-07)

# material type codes
MAT_LAMBERT, MAT_SPECULAR, MAT_GLASS, MAT_GLOSSY, MAT_PLASTIC = range(5)
_MAT_CODES = {
    "lambert": MAT_LAMBERT,
    "specular": MAT_SPECULAR,
    "glass": MAT_GLASS,
    "glossy": MAT_GLOSSY,
    "plastic": MAT_PLASTIC,
}

# light type codes
LIGHT_DISK, LIGHT_RING, LIGHT_ENV, LIGHT_DISTANT = 0, 1, 2, 3


@pytree_dataclass(meta_fields=("width", "height", "marg_steps",
                               "cond_steps"))
@dataclass
class Env2D:
    """Piecewise-constant 2D distribution for env-map importance sampling.

    Parity: Piecewise2DDistribution (texturepattern.cpp:3-109) — marginal
    over rows (v), conditional over columns (u), both with the image's
    v-flip applied at build.
    """

    marg_pdf: Any  # (h,)
    marg_cdf: Any  # (h+1,)
    cond_pdf: Any  # (h, w)
    cond_cdf: Any  # (h, w+1)
    width: int
    height: int
    # inverse-CDF acceleration tables (None on tiny maps): inv[j] =
    # searchsorted(cdf, j/M, 'right') - 1.  A sample u in [j/M, (j+1)/M)
    # has its bin bracketed by [inv[j], inv[j+1]]; the *_steps meta fields
    # are the BUILD-TIME worst-case bisection depths (static, usually 1-3
    # vs log2(h) for the unbracketed search).  See lights.env2d_sample.
    marg_inv: Any = None  # (M+1,) int32, M = pow2 >= 2h
    cond_inv: Any = None  # (h, Mc+1) int32, Mc = min(pow2 >= w, 1024)
    marg_steps: int = 0
    cond_steps: int = 0


@dataclass
class TexRef:
    """A pattern: constant value and/or packed-texture reference."""

    const: Any  # (3,) float32 — used when tex_id < 0
    tex_id: int  # index into packed textures, -1 if constant


@pytree_dataclass(
    meta_fields=("kind", "radius", "inner_radius")
)
@dataclass
class LightData:
    kind: int  # LIGHT_DISK / LIGHT_RING / LIGHT_ENV
    xf: Any  # (4,4) light-to-world (row-major math matrix)
    radius: float
    inner_radius: float
    # pytree LEAF (not meta): the north star trains light radiance, and a
    # leaf intensity carries gradients through every Le evaluation
    intensity: Any  # () float32
    le_const: Any  # (3,)
    # None or (h, w, 3) float32 texture, stored as RAW image rows (no
    # preprocessing); the reference's v-flip happens at LOOKUP (1 - v, like
    # TexturePattern::GetValue, texturepattern.cpp:172-188) in lights.py's
    # _le_value and sample-site fetch
    le_tex: Any
    env2d: Optional[Env2D]  # importance distribution (texture Le only)


@pytree_dataclass(meta_fields=("sigma_maj",))
@dataclass
class MediumData:
    bounds_min: Any  # (3,)
    bounds_max: Any  # (3,)
    # pytree LEAVES: trainable (differentiable volume rendering); the
    # majorant stays META (a static bound baked at load — sampling pdfs are
    # detached, so a stale-but-valid bound only costs variance, never bias)
    sigma_a: Any  # () float32
    sigma_s: Any  # () float32
    le: Any  # (3,)
    density: Any  # (Z, Y, X) float32
    sigma_maj: float  # global majorant: max density * (sigma_a + sigma_s)


@pytree_dataclass(
    meta_fields=("fov", "n_meshes", "n_tris", "tex_slots")
)
@dataclass
class SceneData:
    """Frozen scene: all leaves are arrays (converted lazily by jnp)."""

    # triangle soup (world space)
    tri_v: Any  # (T, 3, 3)
    tri_n: Any  # (T, 3, 3)
    tri_uv: Any  # (T, 3, 2)
    tri_mesh: Any  # (T,) int32
    # per-mesh tables
    mesh_priority: Any  # (M,) int32
    mat_type: Any  # (M,) int32
    rho_d_const: Any  # (M, 3)
    rho_d_tex: Any  # (M,) int32
    rho_s_const: Any
    rho_s_tex: Any
    tau_const: Any
    tau_tex: Any
    eta_const: Any  # (M,)
    eta_tex: Any
    alpha_const: Any  # (M,) pre-squared roughness
    alpha_tex: Any
    has_normal: Any  # (M,) bool
    normal_const: Any  # (M, 3)
    normal_tex: Any  # (M,) int32
    # packed mesh textures
    tex_data: Any  # (P, 3) float32 (roughness textures pre-squared)
    tex_off: Any  # (NT,) int32
    tex_w: Any  # (NT,) int32
    tex_h: Any  # (NT,) int32
    # static members
    lights: list  # list[LightData] — static length, unrolled in jit
    cam_to_world: Any  # (4, 4)
    fov: float
    medium: Optional[MediumData]
    n_meshes: int
    n_tris: int
    # STATIC: which mesh-texture slots have any texture bound (subset of
    # {"rho_d","rho_s","tau","eta","alpha","normal"}).  make_bsdf skips
    # the texture gather of unbound slots at trace time; being a meta
    # field, it specializes the jit per scene structure (not per texel
    # values).
    tex_slots: tuple = ()


def _mat4(vec) -> np.ndarray:
    return np.asarray(vec, np.float32).reshape(4, 4)


_IDENTITY = np.eye(4, dtype=np.float32).reshape(-1).tolist()


class _TexturePacker:
    def __init__(self, asset_root, missing="placeholder"):
        self.asset_root = asset_root
        self.cache = {}  # (path, is_rough) -> tex_id
        self.images = []
        self.missing = missing

    def add(self, path, is_roughness=False):
        key = (path, is_roughness)
        if key in self.cache:
            return self.cache[key]
        img = _read_texture(path, self.asset_root, self.missing)
        if is_roughness:
            img = img * img  # reference squares roughness on fetch
        tid = len(self.images)
        self.images.append(np.ascontiguousarray(img, np.float32))
        self.cache[key] = tid
        return tid

    def pack(self):
        if not self.images:
            return (
                np.zeros((1, 3), np.float32),
                np.zeros((1,), np.int32),
                np.ones((1,), np.int32),
                np.ones((1,), np.int32),
            )
        offs, ws, hs, flat = [], [], [], []
        off = 0
        for img in self.images:
            h, w, _ = img.shape
            offs.append(off)
            ws.append(w)
            hs.append(h)
            flat.append(img.reshape(-1, 3))
            off += h * w
        return (
            np.concatenate(flat, axis=0),
            np.asarray(offs, np.int32),
            np.asarray(ws, np.int32),
            np.asarray(hs, np.int32),
        )


def _read_texture(path, asset_root, missing="placeholder"):
    """Read an EXR texture, substituting a neutral placeholder when the
    asset is absent (several reference textures are large blobs that
    are not distributed with its scenes)."""
    try:
        return exr_mod.read(resolve_asset(path, asset_root))[..., :3]
    except FileNotFoundError:
        if missing != "placeholder":
            raise
        import sys

        print(
            f"warning: texture {path!r} missing; using 0.5 placeholder",
            file=sys.stderr,
        )
        return np.full((4, 4, 3), 0.5, np.float32)


def resolve_asset(path: str, asset_root: str) -> str:
    """Resolve scene-relative asset paths like 'input//meshes//sphere.geo'."""
    path = path.replace("//", "/")
    for base in (asset_root, os.getcwd()):
        cand = os.path.join(base, path)
        if os.path.exists(cand):
            return cand
    if os.path.exists(path):
        return path
    raise FileNotFoundError(f"asset {path!r} not found under {asset_root!r}")


def _clampv(v):
    return np.minimum(np.asarray(v, np.float32), FLT_BEFORE_ONE)


def _get_pattern(packer, node, *, clamp=True, is_roughness=False, scalar=False):
    """Parse a pattern node -> (const (3,), tex_id).

    Parity: Scene::GetRho_d / GetRho_s / GetEta / GetTau / GetAlpha / GetLe
    (scene.cpp:345-590).  Scalars (eta, roughness) broadcast to 3 channels.
    """
    if isinstance(node, dict):
        ptype = node.get("type")
        if ptype == "texture":
            return np.zeros(3, np.float32), packer.add(
                node["filePath"], is_roughness
            )
        if ptype == "constant":
            v = node["value"]
            if scalar or np.isscalar(v):
                v = np.full(3, np.float32(v), np.float32)
                if is_roughness:
                    v = v * v
                return v.astype(np.float32), -1
            v = np.asarray(v, np.float32)
            return (_clampv(v) if clamp else v), -1
        raise ValueError(f"'{ptype}' is not a pattern type")
    if np.isscalar(node):
        v = np.full(3, np.float32(node), np.float32)
        if is_roughness:
            v = v * v
        return v, -1
    v = np.asarray(node, np.float32)
    return (_clampv(v) if clamp else v), -1


def _build_env2d(img: np.ndarray) -> Env2D:
    """Build the marginal/conditional CDFs.  texturepattern.cpp:3-70."""
    h, w, _ = img.shape
    # v-flip: row j of the distribution is image row (h - j - 1)
    lum = np.abs(img[::-1]).sum(axis=2).astype(np.float64)  # (h, w)
    marg = lum.mean(axis=1)  # (h,) — *= invW
    f_int = marg.mean()  # *= invH
    cond = np.where(
        marg[:, None] != 0.0, lum / np.where(marg[:, None] == 0, 1, marg[:, None]), 1.0
    )
    marg = marg / f_int
    marg_cdf = np.zeros(h + 1)
    marg_cdf[1:] = np.cumsum(marg) / h
    marg_cdf[h] = 1.0
    cond_cdf = np.zeros((h, w + 1))
    cond_cdf[:, 1:] = np.cumsum(cond, axis=1) / w
    cond_cdf[:, w] = 1.0
    marg_cdf32 = marg_cdf.astype(np.float32)
    cond_cdf32 = cond_cdf.astype(np.float32)
    # inverse-CDF bracket tables (see Env2D docstring).  Built on the f32
    # CDFs the sampler searches, so the brackets are exact for it.
    marg_inv = cond_inv = None
    marg_steps = cond_steps = 0
    if h > 64:
        # POWER-OF-TWO table sizes: u*M is an exact f32 exponent shift and
        # j/M is exactly representable, so the bracket [inv[j], inv[j+1]]
        # provably contains searchsorted(cdf, u)-1 — no rounding slack
        M = 1 << int(np.ceil(np.log2(2 * h)))
        grid = (np.arange(M + 1) / M).astype(np.float32)
        marg_inv = (
            np.searchsorted(marg_cdf32, grid, side="right").astype(np.int32)
            - 1
        )
        marg_steps = int(
            np.ceil(np.log2(np.maximum(np.diff(marg_inv).max() + 1, 1)))
        )
        Mc = min(1 << int(np.ceil(np.log2(max(w, 2)))), 1024)
        gc = (np.arange(Mc + 1) / Mc).astype(np.float32)
        cond_inv = np.empty((h, Mc + 1), np.int32)
        for r in range(h):
            cond_inv[r] = (
                np.searchsorted(cond_cdf32[r], gc, side="right") - 1
            )
        cond_steps = int(
            np.ceil(
                np.log2(
                    np.maximum(np.diff(cond_inv, axis=1).max() + 1, 1)
                )
            )
        )
    return Env2D(
        marg_pdf=marg.astype(np.float32),
        marg_cdf=marg_cdf32,
        cond_pdf=cond.astype(np.float32),
        cond_cdf=cond_cdf32,
        width=w,
        height=h,
        marg_inv=marg_inv,
        cond_inv=cond_inv,
        marg_steps=marg_steps,
        cond_steps=cond_steps,
    )


def load_scene(scene_path: str, asset_root: Optional[str] = None) -> SceneData:
    with open(scene_path) as f:
        doc = json.load(f)
    if asset_root is None:
        # scenes reference assets as input/... relative to the project root
        d = os.path.dirname(os.path.abspath(scene_path))
        asset_root = os.path.dirname(os.path.dirname(d))

    packer = _TexturePacker(asset_root)

    # ---- camera (scene.cpp:782-875) ----
    cam = doc.get("camera", {})
    fov = float(cam.get("fov", 11.0))
    cam_xf = _mat4(cam.get("transform", _IDENTITY))
    medium = None
    if "medium" in cam:
        m = cam["medium"]
        try:
            grid = vol_mod.load_vol(resolve_asset(m["filePath"], asset_root))
        except FileNotFoundError:
            import sys

            print(
                f"warning: volume {m['filePath']!r} missing; camera medium "
                "disabled",
                file=sys.stderr,
            )
            grid = None
        if grid is not None:
            sigma_a = np.float32(m["sigma_a"])
            sigma_s = np.float32(m["sigma_s"])
            # reference majorant: width-1 grid => single global majorant =
            # max(density verts / corner samples) * (sigma_a + sigma_s)
            sigma_maj = float(grid.density.max()) * (sigma_a + sigma_s)
            medium = MediumData(
                bounds_min=grid.bounds_min,
                bounds_max=grid.bounds_max,
                sigma_a=sigma_a,
                sigma_s=sigma_s,
                le=np.asarray(m["Le"], np.float32),
                density=grid.density,
                sigma_maj=sigma_maj,
            )

    # ---- meshes + materials (scene.cpp:644-780) ----
    mesh_defs = doc.get("meshes", [])
    tri_v, tri_n, tri_uv, tri_mesh = [], [], [], []
    mesh_priority = []
    mat_type = []
    z3 = np.zeros(3, np.float32)
    cols = {
        k: {"const": [], "tex": []}
        for k in ("rho_d", "rho_s", "tau", "eta", "alpha", "normal")
    }
    has_normal = []

    def push(k, const, tex):
        cols[k]["const"].append(const)
        cols[k]["tex"].append(tex)

    for i, md in enumerate(mesh_defs):
        mat = md["material"]
        mtype = mat["type"]
        if mtype not in _MAT_CODES:
            raise ValueError(f"'{mtype}' is not a material type")
        mat_type.append(_MAT_CODES[mtype])
        mesh_priority.append(int(md.get("priority", 0)))

        need = {
            "lambert": ("rho_d",),
            "specular": ("rho_s", "eta"),
            "glass": ("rho_s", "tau", "eta", "alpha"),
            "glossy": ("rho_s", "eta", "alpha"),
            "plastic": ("rho_d", "rho_s", "eta", "alpha"),
        }[mtype]
        for k in ("rho_d", "rho_s", "tau", "eta", "alpha"):
            if k in need:
                src = mat["roughness"] if k == "alpha" else mat[k]
                const, tex = _get_pattern(
                    packer,
                    src,
                    clamp=(k != "rho_d" or isinstance(src, dict)),
                    is_roughness=(k == "alpha"),
                    scalar=(k in ("eta", "alpha")),
                )
            else:
                const, tex = z3, -1
            push(k, const, tex)

        # normal map; glass never gets one (reference ctor bug, preserved)
        n_node = mat.get("normal")
        if n_node is not None and mtype != "glass":
            const, tex = _get_pattern(packer, n_node, clamp=True)
            has_normal.append(True)
            push("normal", const, tex)
        else:
            has_normal.append(False)
            push("normal", z3, -1)

        arr = geo_mod.load_geo(
            resolve_asset(md["filePath"], asset_root), _mat4(md.get("transform", _IDENTITY))
        )
        tri_v.append(arr.v)
        tri_n.append(arr.n)
        tri_uv.append(arr.uv)
        tri_mesh.append(np.full(len(arr.v), i, np.int32))

    if tri_v:
        tri_v = np.concatenate(tri_v)
        tri_n = np.concatenate(tri_n)
        tri_uv = np.concatenate(tri_uv)
        tri_mesh = np.concatenate(tri_mesh)
    else:
        tri_v = np.zeros((1, 3, 3), np.float32)
        tri_n = np.tile(np.array([0, 0, 1], np.float32), (1, 3, 1))
        tri_uv = np.zeros((1, 3, 2), np.float32)
        tri_mesh = np.zeros(1, np.int32)

    # ---- lights (scene.cpp:877-932) ----
    lights = []
    for ld in doc.get("lights", []):
        ltype = ld.get("type")
        if ltype not in ("disk", "ring", "environment", "distant"):
            continue  # parity: unknown types silently skipped
        # "distant" is an extension: the reference defines DistantLight
        # (src/lights/distantlight.cpp) but its loader never constructs it
        # (scene.cpp:894-923 handles only disk/ring/environment)
        xf = _mat4(ld.get("transform", _IDENTITY))
        le_node = ld["Le"]
        le_tex_img = None
        env2d = None
        if isinstance(le_node, dict) and le_node.get("type") == "texture":
            img = _read_texture(le_node["filePath"], asset_root).astype(
                np.float32
            )
            le_tex_img = img
            env2d = _build_env2d(img)  # GetLe always builds the pdf (scene.cpp:569)
            le_const = np.zeros(3, np.float32)
        else:
            le_const, _ = _get_pattern(packer, le_node, clamp=True)
        kind = {
            "disk": LIGHT_DISK,
            "ring": LIGHT_RING,
            "environment": LIGHT_ENV,
            "distant": LIGHT_DISTANT,
        }[ltype]
        lights.append(
            LightData(
                kind=kind,
                xf=xf,
                radius=float(ld.get("radius", 1.0)),
                inner_radius=float(ld.get("innerRadius", 0.0)),
                intensity=np.float32(ld.get("intensity", 1.0)),
                le_const=le_const,
                le_tex=le_tex_img,
                env2d=env2d,
            )
        )

    tex_data, tex_off, tex_w, tex_h = packer.pack()
    n_meshes = max(1, len(mesh_defs))

    def stack(name, ncol=3):
        c = cols[name]["const"]
        t = cols[name]["tex"]
        if not c:
            c, t = [np.zeros(3, np.float32)], [-1]
        return np.stack(c).astype(np.float32), np.asarray(t, np.int32)

    rho_d_c, rho_d_t = stack("rho_d")
    rho_s_c, rho_s_t = stack("rho_s")
    tau_c, tau_t = stack("tau")
    eta_c, eta_t = stack("eta")
    alpha_c, alpha_t = stack("alpha")
    normal_c, normal_t = stack("normal")
    tex_slots = tuple(
        name for name, t in (
            ("rho_d", rho_d_t), ("rho_s", rho_s_t), ("tau", tau_t),
            ("eta", eta_t), ("alpha", alpha_t), ("normal", normal_t),
        ) if (t >= 0).any()
    )

    return SceneData(
        tri_v=tri_v,
        tri_n=tri_n,
        tri_uv=tri_uv,
        tri_mesh=tri_mesh,
        mesh_priority=np.asarray(mesh_priority or [0], np.int32),
        mat_type=np.asarray(mat_type or [0], np.int32),
        rho_d_const=rho_d_c,
        rho_d_tex=rho_d_t,
        rho_s_const=rho_s_c,
        rho_s_tex=rho_s_t,
        tau_const=tau_c,
        tau_tex=tau_t,
        eta_const=eta_c[:, 0],
        eta_tex=eta_t,
        alpha_const=alpha_c[:, 0],
        alpha_tex=alpha_t,
        has_normal=np.asarray(has_normal or [False], bool),
        normal_const=normal_c,
        normal_tex=normal_t,
        tex_data=tex_data,
        tex_off=tex_off,
        tex_w=tex_w,
        tex_h=tex_h,
        lights=lights,
        cam_to_world=cam_xf,
        fov=fov,
        tex_slots=tex_slots,
        medium=medium,
        n_meshes=n_meshes,
        n_tris=len(tri_v),
    )
