"""The weights and the map statistics both sides are handed: read from the
checked-in artifact (its digest checked against the configuration file)
or made on the device from the seed, in one draw for every kernel."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

import perfbench.reference as ref
from perfbench.harness.cell import ROOT


def shapes(cfg: dict) -> dict:
    """{state-dict name: (shape, init)} of the configuration's network
    (its reference file's `shapes`, at its family's widths)."""
    fam = ref.family(cfg)
    return ref.net(cfg).shapes(cfg, fam.n_feat(cfg), fam.n_outp(cfg))


def seeded(cfg: dict, draws) -> dict:
    """Weights drawn on the draws' device: one normal draw for all kernels,
    the orthogonal ones as the Q of one batched QR."""
    spec = shapes(cfg)
    dev = draws.device
    normal = [n for n, (_, init) in spec.items() if init.startswith("fan_in")]
    ortho = [n for n, (_, init) in spec.items() if init == "orthogonal"]
    sizes = [int(np.prod(spec[n][0])) for n in normal]
    flat = draws.normal((sum(sizes),))
    out, pos = {}, 0
    for n, size in zip(normal, sizes):
        fan_in = int(spec[n][1].split(":")[1])
        out[n] = (flat[pos:pos + size] * fan_in ** -0.5).reshape(spec[n][0])
        pos += size
    if ortho:
        m = spec[ortho[0]][0][0]
        q, r = torch.linalg.qr(draws.normal((len(ortho), m, m)))
        q = q * torch.sign(torch.diagonal(r, dim1=1, dim2=2))[:, None, :]
        out.update(zip(ortho, q))
    for n, (shape, init) in spec.items():
        if init in ("zeros", "ones"):
            out[n] = (torch.zeros if init == "zeros" else torch.ones)(shape, device=dev)
    return {n: out[n].contiguous() for n in spec}


def _checked(path: str, sha256: str) -> str:
    full = os.path.join(ROOT, path)
    with open(full, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != sha256:
        raise ValueError(f"{path}: sha256 {digest}, the configuration states {sha256}")
    return full


def artifact(cfg: dict, device) -> dict:
    """The checked-in checkpoint's leaves (`p0..`, Flax's order: dict keys
    sorted at every level) under the state-dict names."""
    w = cfg["weights"]
    z = np.load(_checked(w["params"], w["params_sha256"]))
    spec = shapes(cfg)
    names = sorted(spec, key=lambda k: tuple(k.split(".")))
    if len(z.files) != len(names):
        raise ValueError(f"{w['params']}: {len(z.files)} leaves, expected {len(names)}")
    out = {}
    for i, n in enumerate(names):
        arr = z[f"p{i}"]
        if arr.shape != spec[n][0]:
            raise ValueError(f"p{i} ({n}): shape {arr.shape}, expected {spec[n][0]}")
        out[n] = torch.as_tensor(arr, device=device)
    if sum(v.numel() for v in out.values()) != w["n_params"]:
        raise ValueError(f"{w['params']}: not {w['n_params']} parameters")
    return {n: out[n] for n in spec}


def params(cfg: dict, draws, tiny: bool) -> dict:
    if cfg["weights"]["kind"] == "artifact" and not tiny:
        return artifact(cfg, draws.device)
    return seeded(cfg, draws)


def stats(cfg: dict, device) -> dict:
    """The map's statistics: every array of the configuration's statistics
    file, by its name there (DBNormalCDF: `xi_map.mu`, `xi_map.sigma`)."""
    z = np.load(_checked(cfg["stats"]["path"], cfg["stats"]["sha256"]))
    return {k: torch.as_tensor(z[k], device=device) for k in z.files}
