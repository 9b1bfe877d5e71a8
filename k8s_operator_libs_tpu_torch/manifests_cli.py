"""Render the port's install manifests, or check the checked-in render.

    python -m k8s_operator_libs_tpu_torch.manifests          # (re)write
    python -m k8s_operator_libs_tpu_torch.manifests --check  # exit 1 if stale

``manifests.py`` builds the manifests; this module writes them, as one
YAML file, to ``deploy/controller.yaml`` beside it.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

from k8s_operator_libs_tpu_torch.manifests import controller_manifests

# The rendered install manifests, checked in beside this module.
RENDERED_PATH = Path(__file__).resolve().parent / "deploy" / "controller.yaml"
RENDER_HEADER = (
    "# Generated by `python -m k8s_operator_libs_tpu_torch.manifests`; "
    "do not edit.\n"
    "# Check: `python -m k8s_operator_libs_tpu_torch.manifests --check`.\n"
    "# Install the CRD first: kubectl apply -f config/crd/\n"
)


def render() -> str:
    """The install manifests as one multi-document YAML file."""
    import yaml

    return RENDER_HEADER + "---\n".join(
        yaml.safe_dump(d, sort_keys=True, default_flow_style=False)
        for d in controller_manifests()
    )


def main(argv: Optional[list[str]] = None) -> int:
    """Write the rendered manifests to ``RENDERED_PATH``; with
    ``--check``, exit 1 when the checked-in file is missing or stale."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args(argv)
    content = render()
    if args.check:
        if not RENDERED_PATH.is_file() or RENDERED_PATH.read_text() != content:
            print(f"manifests: {RENDERED_PATH} is missing or stale; "
                  "rerun without --check")
            return 1
        print("manifests: up to date")
        return 0
    RENDERED_PATH.parent.mkdir(parents=True, exist_ok=True)
    RENDERED_PATH.write_text(content)
    print(f"manifests: wrote {RENDERED_PATH}")
    return 0

