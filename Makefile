# Build/test toolchain — analogue of the reference's Makefile targets
# (make all|lint|test|cov-report, reference Makefile:60-86) for the
# Python/JAX stack.

PYTHON ?= python
DOCKER ?= docker
# The runtime image tag config/manifests/controller.yaml references
# (k8s_operator_libs_tpu/manifests.py DEFAULT_IMAGE) — `make
# docker-build` produces exactly what `kubectl apply` pulls.
IMAGE ?= tpu-operator-libs
TAG ?= latest
BUILDIMAGE ?= $(IMAGE)-devel:$(TAG)

.PHONY: all test test-fast chaos lint typecheck cov-report bench \
	bench-guard graft-check clean generate generate-check docker-build \
	docker-push .build-image plan whatif profile trace health-report

all: lint test

# Regenerate the TPUUpgradePolicy CRD + state diagram (controller-gen
# analogue; reference Makefile:60-66 `make generate`).
generate:
	$(PYTHON) tools/gen_crd.py
	$(PYTHON) tools/gen_state_diagram.py
	$(PYTHON) tools/gen_manifests.py

# Fail on generated-file drift (reference ci.yaml go-check job).
generate-check:
	$(PYTHON) tools/gen_crd.py --check
	$(PYTHON) tools/gen_state_diagram.py --check
	$(PYTHON) tools/gen_manifests.py --check

test:
	$(PYTHON) -m pytest tests/ -q

# Skip the slower JAX-compiling tiers (canary, ring attention, chaos).
test-fast:
	$(PYTHON) -m pytest tests/ -q \
		--ignore=tests/test_canary.py \
		--ignore=tests/test_ring_attention.py \
		--ignore=tests/test_chaos.py

# The fault-injection ladder (breaker/retry, node faults, chaos rolls,
# seeded fuzz, federation partitions), one pytest process per battery
# with a summary table — tools/chaos_run.py pins PYTHONHASHSEED=0 and
# isolates each battery so a crash or hang cannot mask the rest.
chaos:
	$(PYTHON) tools/chaos_run.py

# The in-repo linter (tools/lint.py: syntax, unused imports, undefined
# names, bare excepts, mutable defaults) is the hard gate and always
# runs; ruff adds broader checks when installed.  No silent fallback.
lint:
	$(PYTHON) tools/lint.py k8s_operator_libs_tpu tests tools examples \
		bench.py __graft_entry__.py
	@if $(PYTHON) -c "import ruff" 2>/dev/null; then \
		$(PYTHON) -m ruff check k8s_operator_libs_tpu tests tools examples; \
	fi

# Static check of the typed client boundary (KubeClient Protocol,
# k8s/interface.py) plus the fault-tolerance layer.  mypy is not baked
# into every dev image, so locally the target degrades to a loud skip
# when it is absent; in CI (CI env var set) a missing mypy is a broken
# toolchain and FAILS the build instead of silently passing.  The
# runtime conformance tests (tests/test_client_interface.py) are the
# always-on gate either way.
typecheck:
	@if $(PYTHON) -c "import mypy" 2>/dev/null; then \
		$(PYTHON) -m mypy --ignore-missing-imports \
			--follow-imports=silent \
			k8s_operator_libs_tpu/k8s/interface.py \
			k8s_operator_libs_tpu/k8s/client.py \
			k8s_operator_libs_tpu/k8s/faults.py \
			k8s_operator_libs_tpu/k8s/retry.py \
			k8s_operator_libs_tpu/k8s/rest.py \
			k8s_operator_libs_tpu/upgrade/; \
	elif [ -n "$$CI" ]; then \
		echo "typecheck: mypy not installed but CI is set —" \
			"the CI image must bake in mypy; failing" >&2; \
		exit 1; \
	else \
		echo "typecheck: mypy not installed; skipping" \
			"(pip install mypy, or run 'make docker-typecheck')"; \
	fi

# Line coverage via the in-repo sys.monitoring runner; fails the build
# under the threshold (reference parity: ci.yaml:50-66 coverage gate).
COV_THRESHOLD ?= 90
cov-report:
	$(PYTHON) tools/cover.py --threshold $(COV_THRESHOLD) --report \
		-- tests/ -q

bench:
	$(PYTHON) bench.py

# Hot-path regression gate, two stages: (1) steady-state cached
# reconcile at 256 nodes must stay under the pinned
# api_requests_per_tick ceiling (the informer serves every read);
# (2) sharded dirty-set reconcile at 4096 nodes must keep tick cost
# O(changed) — idle ticks walk 0 pools under the p99 latency ceiling,
# one delta walks exactly 1 pool (see tools/bench_guard.py).
bench-guard:
	$(PYTHON) tools/bench_guard.py

# Print the analytic roll plan for the current cluster without issuing
# a single API write verb (the controller's --dry-run path; see
# docs/rollout-planning.md).  Pass ARGS="--namespace ... --policy ..."
# to point it at a live CR.
plan:
	$(PYTHON) -m k8s_operator_libs_tpu.controller --dry-run $(ARGS)

# What-if scoring: roll the digital twin under the current policy AND
# under POLICY=<file>, print the makespan delta.  Same zero-write
# contract as `make plan` — the live cluster sees only reads.
whatif:
	$(PYTHON) -m k8s_operator_libs_tpu.controller \
		--score-policy $(POLICY) $(ARGS)

# cProfile over one 256-node active-roll reconcile tick (top 25 by
# cumulative time) — the first stop when bench-guard regresses.
profile:
	$(PYTHON) tools/profile_tick.py

# Drive a fake-tier roll with tracing on and print the completed causal
# span tree plus its critical-path makespan attribution (see
# docs/observability.md).
trace:
	$(PYTHON) tools/trace_roll.py

# Fleet health report: per-generation probe baselines, the node
# health-score distribution and any confirmed stragglers — from a live
# controller (ARGS="--metrics-url http://host:port/metrics") or, by
# default, a synthetic mixed-generation fleet (see docs/observability.md
# "Fleet health telemetry").
health-report:
	$(PYTHON) tools/health_report.py $(ARGS)

graft-check:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PYTHON) __graft_entry__.py

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
	rm -rf .pytest_cache

# -- container images (reference Makefile:94-121 analogue) -------------------

# Runtime image for controller/agent/status/safe-load-init; the install
# manifests reference $(IMAGE):$(TAG).
docker-build:
	$(DOCKER) build --progress=plain \
		--tag $(IMAGE):$(TAG) \
		-f docker/Dockerfile .

docker-push:
	$(DOCKER) push $(IMAGE):$(TAG)

# Devel image + containerized make targets: `make docker-lint`,
# `make docker-test`, ... run the target inside the devel image with the
# tree bind-mounted (reference's $(DOCKER_TARGETS) pattern).
.build-image: docker/Dockerfile.devel
	$(DOCKER) build --progress=plain \
		--tag $(BUILDIMAGE) \
		-f docker/Dockerfile.devel .

docker-%: .build-image
	@echo "Running 'make $(*)' in $(BUILDIMAGE)"
	$(DOCKER) run --rm \
		-v $(PWD):/workspace -w /workspace \
		--user $$(id -u):$$(id -g) \
		$(BUILDIMAGE) make $(*)

# -- the PyTorch/CUDA port's image --------------------------------------------

# Runtime image of k8s_operator_libs_tpu_torch, its CUDA kernels prebuilt
# in the image's build stage; the port's deploy/controller.yaml and its
# DaemonSets pull $(TORCH_IMAGE):$(TAG) (keys.py OPERATOR_IMAGE).
TORCH_IMAGE ?= tpu-operator-libs-torch

.PHONY: docker-build-torch

docker-build-torch:
	$(DOCKER) build --progress=plain \
		--tag $(TORCH_IMAGE):$(TAG) \
		-f docker/Dockerfile.torch .
