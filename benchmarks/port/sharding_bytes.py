"""Per-device parameter bytes under the reference's FSDP specs and the port's.

    PYTHONPATH=src python benchmarks/port/sharding_bytes.py

The reference shards its stacked layout, where the data axis can take the
leading ``n_periods`` axis of a block leaf; the port has one module a
layer, and ``runtime/sharding.layer_spec`` moves that axis to the layer's
first unsharded dim it divides.  For every architecture at its published
widths, on the production meshes (16, 16) and (2, 16, 16), this prints the
bytes one device holds of the parameters (each leaf's bytes over the
product of the mesh axes its spec names) under both, computed from shapes
on the meta device and the specs alone: no process group, no device.
"""
from __future__ import annotations

import json

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import transformer as T
from repro_torch.models.convert import to_jax_layout
from repro_torch.runtime import sharding as SH

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _factor(spec, sizes) -> int:
    out = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (() if entry is None else (entry,))):
            out *= sizes[a]
    return out


def _leaves(tree, specs):
    if isinstance(specs, SH.PartitionSpec):
        yield tree, specs
        return
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    for k, s in items:
        yield from _leaves(tree[k], s)


def per_device_bytes(arch: str, mesh_name: str) -> dict:
    cfg = get_config(arch)
    mesh = SH.MeshShape(*MESHES[mesh_name])
    named = dict(T.init_params(cfg, None, "meta").named_parameters())
    stacked = to_jax_layout(named, cfg)
    specs = SH.fsdp_pspecs(SH.param_pspecs(stacked, mesh, special_kv_heads=cfg.n_kv_heads),
                           stacked, mesh)
    ref = sum(t.numel() * t.element_size() / _factor(s, mesh.shape)
              for t, s in _leaves(stacked, specs))
    port_specs = SH.port_pspecs(named, cfg, mesh, "fsdp")
    port = sum(t.numel() * t.element_size() / _factor(port_specs[k], mesh.shape)
               for k, t in named.items())
    total = sum(t.numel() * t.element_size() for t in named.values())
    return {"arch": arch, "mesh": mesh_name, "total_bytes": total,
            "reference_per_device": ref, "port_per_device": port,
            "port_over_reference": port / ref}


def main() -> None:
    torch.set_grad_enabled(False)
    rows = [per_device_bytes(a, m) for a in sorted(ARCHS) for m in MESHES]
    print("| arch | mesh | params GB | reference GB/device | port GB/device | port / ref |")
    print("| --- | --- | --- | --- | --- | --- |")
    for r in rows:
        print(f"| {r['arch']} | {r['mesh']} | {r['total_bytes'] / 1e9:.2f} | "
              f"{r['reference_per_device'] / 1e9:.4f} | {r['port_per_device'] / 1e9:.4f} | "
              f"{r['port_over_reference']:.4f} |")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
