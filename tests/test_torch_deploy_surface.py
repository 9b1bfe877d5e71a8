"""The JAX package's ``tests/test_deploy_surface.py`` against the port's
install surface: ``docker/Dockerfile.torch``, the Makefile's
``docker-build-torch`` target and ``TORCH_IMAGE``, and the port's
``deploy/controller.yaml``, pinned to ``keys.OPERATOR_IMAGE``.

``port_module`` runs the file's source with the package prefix rewritten;
``SUBSTITUTIONS`` point its reads at the port's files.  One case departs
by design (``DEPARTURES``): the port's image must not install the
project's dependencies, which carry jax, and its mirror holds the port's
requirement line instead.  The cases after it pin what the reference's
image has no need of: the kernels compiled in the build stage into the
directory the runtime stage copies and names, no toolkit at run time,
and no copy of the JAX package.
"""

from __future__ import annotations

import re
import subprocess
import sys

from k8s_operator_libs_tpu_torch.keys import OPERATOR_IMAGE
from k8s_operator_libs_tpu_torch.manifests import DEFAULT_IMAGE
from k8s_operator_libs_tpu_torch.kernels.build import ENTRY, KERNEL_DIR_ENV
from tests.test_torch_control_plane import (
    ROOT,
    departed,
    port_module,
    port_tests,
    unmirrored,
)

SUBSTITUTIONS = (
    ('_read("config", "manifests", "controller.yaml")',
     '_read("k8s_operator_libs_tpu_torch", "deploy", "controller.yaml")'),
    ('f"IMAGE ?= {image}"', 'f"TORCH_IMAGE ?= {image}"'),
    ('"docker-build:" in makefile', '"docker-build-torch:" in makefile'),
    ('"-f docker/Dockerfile ." in makefile',
     '"-f docker/Dockerfile.torch ." in makefile'),
    ('def test_runtime_dockerfile_installs_the_package():\n'
     '    df = _read("docker", "Dockerfile")',
     'def test_runtime_dockerfile_installs_the_package():\n'
     '    df = _read("docker", "Dockerfile.torch")'),
)
# Reference cases that cannot hold on the port, each with its reason and
# the port case that mirrors it.
DEPARTURES = {
    "test_dockerfile_dependency_extraction_matches_pyproject": (
        "the port's image installs the project's dependencies but jax and "
        "optax, plus the torch extra",
        "test_port_dockerfile_requirements_are_the_port_s",
    ),
}

globals().update(departed(port_tests(port_module(
    "test_deploy_surface.py", substitutions=SUBSTITUTIONS)), DEPARTURES))

DOCKERFILE = ROOT / "docker" / "Dockerfile.torch"


def _stages() -> list[str]:
    """The Dockerfile's stages, each from its ``FROM`` line on."""
    text = DOCKERFILE.read_text()
    starts = [m.start() for m in re.finditer(r"^FROM ", text, re.MULTILINE)]
    return [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]


def _instructions(stage: str) -> list[str]:
    """A stage's instructions, comments dropped and continuations
    joined."""
    lines = [ln for ln in stage.splitlines() if not ln.startswith("#")]
    return [i.strip() for i in "\n".join(lines).replace("\\\n", " ")
            .splitlines() if i.strip()]


def test_every_departure_has_its_mirror():
    assert unmirrored(DEPARTURES, globals()) == []


def test_port_dockerfile_requirements_are_the_port_s():
    """The mirror of the reference's extraction case: the RUN line that
    derives the image's requirements from pyproject yields numpy, PyYAML
    and torch, and neither jax nor optax."""
    m = re.search(r'RUN python -c "(.+?)" >', DOCKERFILE.read_text())
    assert m, "requirement-extraction RUN line missing"
    out = subprocess.run([sys.executable, "-c", m.group(1)],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    names = [re.split(r"[<>=\[ ]", d)[0] for d in out.stdout.split()]
    assert names == ["numpy", "PyYAML", "torch"]


def test_the_image_is_the_tag_the_port_pulls():
    """The reference's image case above reads the manifests' default;
    the target tags ``keys.OPERATOR_IMAGE`` itself, the image the port's
    DaemonSets pull too."""
    assert DEFAULT_IMAGE == OPERATOR_IMAGE
    makefile = (ROOT / "Makefile").read_text()
    target = makefile.split("docker-build-torch:\n", 1)[1].split("\n\n")[0]
    assert "--tag $(TORCH_IMAGE):$(TAG)" in target
    assert ".PHONY: docker-build-torch" in makefile


def test_the_build_stage_prebuilds_the_kernels_the_runtime_loads():
    """The build stage runs the build entry with the kernel directory set;
    the runtime stage copies that directory and names it in the same
    setting, so the installed package finds its library there."""
    build, runtime = _stages()
    assert re.match(r"FROM \S+devel\S* AS build\b", build)
    setting = re.compile(rf"^ENV {KERNEL_DIR_ENV}=(\S+)$")
    built_into = [m.group(1) for i in _instructions(build)
                  if (m := setting.match(i))]
    assert len(built_into) == 1
    kernel_dir = built_into[0]
    build_steps = _instructions(build)
    entry = next(i for i, s in enumerate(build_steps)
                 if f"python -m {ENTRY}" in s)
    assert build_steps.index(f"ENV {KERNEL_DIR_ENV}={kernel_dir}") < entry
    assert any(s.startswith("RUN pip install") and "--no-deps ." in s
               for s in build_steps[:entry])
    steps = _instructions(runtime)
    assert f"COPY --from=build {kernel_dir} {kernel_dir}" in steps
    assert f"ENV {KERNEL_DIR_ENV}={kernel_dir}" in steps


def test_the_runtime_stage_has_no_toolkit_and_runs_as_65532():
    _, runtime = _stages()
    steps = _instructions(runtime)
    assert "devel" not in steps[0]
    assert not any("nvcc" in s or ENTRY in s for s in steps)
    users = [s for s in steps if s.startswith("USER ")]
    assert users == ["USER 65532"]
    assert steps[-1] == ('ENTRYPOINT ["python", "-m", '
                         '"k8s_operator_libs_tpu_torch.controller"]')


def test_the_image_copies_no_jax_package():
    steps = [s for stage in _stages() for s in _instructions(stage)]
    copies = [s for s in steps if s.startswith("COPY ")]
    assert "COPY k8s_operator_libs_tpu_torch ./k8s_operator_libs_tpu_torch" \
        in copies
    assert not any(re.search(r"\bk8s_operator_libs_tpu\b(?!_torch)", s)
                   for s in copies)
