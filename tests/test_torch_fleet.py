"""The JAX package's ``tests/test_fleet.py`` against the port (generation
profiles, maintenance windows, generation-aware ordering, pool budgets,
preemption, write coalescing and the status fleet section).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.  The port's profiles hold the three H100 parts
and no TPU generation (``fleet/profiles.py``), so the file's four TPU
accelerators become H100 parts of the same rank, as GPU Feature
Discovery names them (``H100_FOR_TPU``; v5e and v5p both the SXM part,
between PCIe and NVL), and the generation names its engine and status
cases read become the parts' (``GENERATION_FOR_TPU``).

The chip-spec aliases and the profile registry of the TPU generations
depart by design (``DEPARTURES``): each is mirrored by a case
parametrised over the port's parts, at least as many cases as the
reference's.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from k8s_operator_libs_tpu_torch.fleet import (
    GenerationProfile,
    generation_of,
    generation_profile,
    known_generations,
    order_groups,
    register_generation,
)
from k8s_operator_libs_tpu_torch.fleet.profiles import (
    HBM_FLOOR_FRACTION,
    ICI_FLOOR_FRACTION,
    MXU_FLOOR_FRACTION,
)
from k8s_operator_libs_tpu_torch.health.probes import resolve_floors
from k8s_operator_libs_tpu_torch.hw import chip_spec
from tests.test_torch_control_plane import (
    departed,
    port_module,
    port_tests,
    unmirrored,
)

PCIE, SXM, NVL = "NVIDIA-H100-PCIe", "NVIDIA-H100-80GB-HBM3", "NVIDIA-H100-NVL"
# Three parts for four generations: v5e and v5p share the SXM part, so the
# scheduler cases order ``c-v5e`` before ``d-v5p`` by the id tie-break
# alone.  ``TestH100Order`` holds each pair of parts against ids that run
# the other way.
H100_FOR_TPU = {
    "tpu-v4-podslice": PCIE,
    "tpu-v5-lite-podslice": SXM,
    "tpu-v5p-slice": SXM,
    "tpu-v6e-slice": NVL,
}
GENERATION_FOR_TPU = {"v4": "h100-pcie", "v5e": "h100-sxm"}
# The port's parts, oldest first, each with its published figures (bf16
# TFLOPS, HBM GB/s, HBM GiB: NVIDIA's data sheet, hw.py's table).
PARTS = {
    "h100-pcie": (PCIE, (756.0, 2000.0, 80.0)),
    "h100-sxm": (SXM, (989.0, 3350.0, 80.0)),
    "h100-nvl": (NVL, (835.0, 3900.0, 94.0)),
}
# Each part's spellings: the CUDA device name, GPU Feature Discovery's
# product label and, for the SXM part, GKE's accelerator labels.
KINDS = [
    ("NVIDIA H100 PCIe", "h100-pcie"),
    (PCIE, "h100-pcie"),
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    (SXM, "h100-sxm"),
    ("NVIDIA-H100-SXM5-80GB", "h100-sxm"),
    ("nvidia-h100-80gb", "h100-sxm"),
    ("nvidia-h100-mega-80gb", "h100-sxm"),
    ("NVIDIA H100 NVL", "h100-nvl"),
    (NVL, "h100-nvl"),
    ("nvidia-h100-nvl", "h100-nvl"),
]
# One device name and one product label a part.
LABELS_AND_NAMES = [KINDS[i] for i in (0, 1, 2, 3, 7, 8)]

SUBSTITUTIONS = (
    *((f'= "{tpu}"\n', f'= "{gpu}"\n') for tpu, gpu in H100_FOR_TPU.items()),
    *((f'{before}assert mgr.preemptions == {{"v4": 1}}',
       f'{before}assert mgr.preemptions == {{"h100-pcie": 1}}')
      for before in ("quarantines_total == 0\n        ",
                     "double-count.\n        ", "(10.0)\n        ")),
    ('preemptions_total{generation="v4"}',
     'preemptions_total{generation="h100-pcie"}'),
    *((f'fleet["generations"]["{tpu}"]', f'fleet["generations"]["{gpu}"]')
      for tpu, gpu in GENERATION_FOR_TPU.items()),
)

# Reference cases that cannot hold on the port, each with its reason and
# the port case that mirrors it.
_TPU = "the port's chip table and profiles hold the three H100 parts, "
DEPARTURES = {
    "TestChipSpecAliases.test_device_kind_and_gke_label_aliases": (
        _TPU + "not the TPU device kinds and GKE TPU labels",
        "TestH100Profiles.test_device_kinds_and_labels_resolve"),
    "TestChipSpecAliases.test_v5p_and_v6e_published_figures": (
        _TPU + "with H100 data-sheet figures",
        "TestH100Profiles.test_published_figures"),
    "TestGenerationProfiles.test_builtin_registry_covers_the_fleet": (
        _TPU + "not v2-v6e",
        "TestH100Profiles.test_builtin_registry_covers_the_fleet"),
    "TestGenerationProfiles.test_resolution_accepts_labels_and_device_kinds": (
        _TPU + "resolved from device names and product labels",
        "TestH100Profiles.test_resolution_accepts_labels_and_device_kinds"),
    "TestGenerationProfiles.test_floors_default_to_fractions_of_chip_spec": (
        _TPU + "whose floors it derives",
        "TestH100Profiles.test_floors_default_to_fractions_of_chip_spec"),
    "TestGenerationProfiles.test_explicit_fraction_beats_pinned_floor": (
        _TPU + "(the case pins a v5p chip)",
        "TestH100Profiles.test_explicit_fraction_beats_pinned_floor"),
    "TestGenerationProfiles.test_register_generation_extends_and_overrides": (
        _TPU + "(the case overrides v6e)",
        "TestH100Profiles.test_register_generation_extends_and_overrides"),
    "TestGenerationProfiles.test_resolve_floors_per_generation": (
        _TPU + "whose floor bundles the battery stamps",
        "TestH100Profiles.test_resolve_floors_per_generation"),
    "TestGenerationProfiles.test_resolve_floors_distinct_per_generation": (
        _TPU + "three, not four production generations",
        "TestH100Profiles.test_resolve_floors_distinct_per_generation"),
    "TestGenerationProfiles.test_preemptible_metadata": (
        _TPU + "none preemptible (v5e and v6e are)",
        "TestH100Profiles.test_preemptible_metadata"),
}

globals().update(departed(port_tests(port_module(
    "test_fleet.py", substitutions=SUBSTITUTIONS)), DEPARTURES))


def test_every_departure_has_its_mirror():
    assert unmirrored(DEPARTURES, globals()) == []


class TestH100Profiles:
    """The mirrors of the departed chip-spec and registry cases, over the
    port's three parts."""

    @pytest.mark.parametrize("kind,name", KINDS)
    def test_device_kinds_and_labels_resolve(self, kind, name):
        spec = chip_spec(kind)
        assert spec is not None and spec.name == name

    @pytest.mark.parametrize("name", PARTS)
    def test_published_figures(self, name):
        spec = chip_spec(PARTS[name][0])
        assert (spec.bf16_tflops, spec.hbm_gbps, spec.hbm_gib) == PARTS[name][1]

    @pytest.mark.parametrize("rank, name", enumerate(PARTS))
    def test_builtin_registry_covers_the_fleet(self, rank, name):
        profiles = known_generations()
        assert [p.name for p in profiles] == list(PARTS)
        assert profiles[rank].name == name
        assert profiles[rank].order == sorted(p.order for p in profiles)[rank]
        assert profiles[rank].chips_per_host == 8

    @pytest.mark.parametrize("kind,name", LABELS_AND_NAMES)
    def test_resolution_accepts_labels_and_device_kinds(self, kind, name):
        profile = generation_profile(kind)
        assert profile is not None and profile.name == name
        assert generation_of(kind) == name

    @pytest.mark.parametrize("name", PARTS)
    def test_floors_default_to_fractions_of_chip_spec(self, name):
        p = generation_profile(PARTS[name][0])
        assert p.hbm_floor() == pytest.approx(
            HBM_FLOOR_FRACTION * p.chip.hbm_gbps)
        assert p.mxu_floor() == pytest.approx(
            MXU_FLOOR_FRACTION * p.chip.bf16_tflops)
        assert p.ici_floor() == pytest.approx(ICI_FLOOR_FRACTION * p.ici_gbps)

    @pytest.mark.parametrize("name", PARTS)
    def test_explicit_fraction_beats_pinned_floor(self, name):
        spec = chip_spec(PARTS[name][0])
        p = GenerationProfile(
            name="pinned", chip=spec, chips_per_host=8, ici_gbps=450.0,
            watts_per_chip=700.0, order=9, hbm_gbps_floor=1000.0,
        )
        assert p.hbm_floor() == 1000.0  # pinned wins over the default
        assert p.hbm_floor(0.25) == pytest.approx(0.25 * spec.hbm_gbps)

    @pytest.mark.parametrize("name", PARTS)
    def test_register_generation_extends_and_overrides(self, name):
        kind = PARTS[name][0]
        original = generation_profile(kind)
        try:
            register_generation(GenerationProfile(
                name=name, chip=original.chip, chips_per_host=8,
                ici_gbps=original.ici_gbps,
                watts_per_chip=original.watts_per_chip,
                order=original.order, preemptible=True,
                hbm_gbps_floor=123.0, mxu_tflops_floor=45.0,
            ))
            p = generation_profile(kind)
            assert p.hbm_floor() == 123.0
            assert p.mxu_floor() == 45.0
        finally:
            register_generation(original)
        assert generation_profile(kind).hbm_floor() == pytest.approx(
            HBM_FLOOR_FRACTION * original.chip.hbm_gbps)

    @pytest.mark.parametrize("kind,name", LABELS_AND_NAMES)
    def test_resolve_floors_per_generation(self, kind, name):
        floors = resolve_floors(kind)
        p = generation_profile(kind)
        assert floors.generation == p.name == name
        assert floors.mxu_tflops == pytest.approx(p.mxu_floor())
        assert floors.hbm_gbps == pytest.approx(p.hbm_floor())
        assert floors.ici_busbw_gbps == pytest.approx(p.ici_floor())
        assert floors.allreduce_latency_ms == p.allreduce_latency_ceiling_ms

    @pytest.mark.parametrize("older, newer", [
        ("h100-pcie", "h100-sxm"), ("h100-sxm", "h100-nvl"),
        ("h100-pcie", "h100-nvl"),
    ])
    def test_resolve_floors_distinct_per_generation(self, older, newer):
        """A PCIe node must not be judged at SXM spec: each pair of parts
        has distinct floor bundles, the HBM floor rising with the part."""
        a = resolve_floors(PARTS[older][0])
        b = resolve_floors(PARTS[newer][0])
        assert a != b
        assert a.hbm_gbps < b.hbm_gbps

    @pytest.mark.parametrize("name", PARTS)
    def test_preemptible_metadata(self, name):
        kind = PARTS[name][0]
        original = generation_profile(kind)
        assert not original.preemptible
        try:
            register_generation(GenerationProfile(
                name=name, chip=original.chip,
                chips_per_host=original.chips_per_host,
                ici_gbps=original.ici_gbps,
                watts_per_chip=original.watts_per_chip,
                order=original.order, preemptible=True,
            ))
            assert generation_profile(kind).preemptible
        finally:
            register_generation(original)
        assert not generation_profile(kind).preemptible


class TestH100Order:
    """The scheduler orders each pair of parts oldest first, against
    ids that sort the other way (the reference's v5e-before-v5p case
    holds on the port by the id tie-break only)."""

    @pytest.mark.parametrize("older, newer", [
        ("h100-pcie", "h100-sxm"), ("h100-sxm", "h100-nvl"),
        ("h100-pcie", "h100-nvl"),
    ])
    def test_older_part_first_whatever_the_id(self, older, newer):
        groups = [
            SimpleNamespace(id=gid, slice_info=SimpleNamespace(
                accelerator=PARTS[name][0]))
            for gid, name in (("a-newer", newer), ("b-older", older))
        ]
        assert [g.id for g in order_groups(groups)] == ["b-older", "a-newer"]
