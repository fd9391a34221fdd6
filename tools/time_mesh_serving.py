"""Mesh phases from one tree: ``chip_smoke.py``'s ``mesh_ssm`` and
``mesh_audio`` phases (or ``--phases``: any family phase, ``mesh_moe`` or
a mesh-train phase) of the tree at ``--root`` (its kernels built into
that tree's ``build/``), for parent-against-change comparisons on one card.

    python3 tools/time_mesh_serving.py --root DIR [--phases P ...]

Run two trees in turns in one command on one card (parent, change, change, parent;
unpack the other with ``git archive`` under ``build/``) and compare the
``ms_per_model_decode_step`` (a train phase: ``ms_per_step``) of their
``"mode"`` rows.  Needs one CUDA card.
"""
import argparse
import json
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="the tree to run")
    ap.add_argument("--phases", nargs="+", default=["mesh_ssm", "mesh_audio"])
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_env(torch)
    cs.phase_build()
    for phase in args.phases:
        if phase == "mesh_moe":
            cs.timed(phase, cs.phase_mesh_moe, torch, dev)
        elif phase.startswith("mesh_train"):
            cs.timed(phase, cs.phase_mesh_train, torch, dev, phase)
        else:
            cs.timed(phase, cs.phase_mesh_family, torch, dev, phase)
    print(json.dumps({"ok": True, "root": str(root)}))


if __name__ == "__main__":
    main()
