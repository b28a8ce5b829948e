# Build plane (reference analog: Makefile:79-174 — build / docker-build /
# install / deploy / test / test-e2e via kustomize + controller-gen; here
# the manifests are generated from Python and the native lib via make).

PY ?= python
IMG_PREFIX ?= instaslice-tpu
TAG ?= latest
KUBECTL ?= kubectl
PROTOC ?= protoc

.PHONY: all
all: native manifests test

# ---------------------------------------------------------------- codegen

.PHONY: manifests
manifests:  ## Regenerate config/crd/bases from instaslice_tpu.api.crd
	$(PY) tools/gen_manifests.py

.PHONY: proto
proto:  ## Regenerate device-plugin protobuf messages
	$(PROTOC) -I instaslice_tpu/deviceplugin/proto \
	  --python_out=instaslice_tpu/deviceplugin \
	  instaslice_tpu/deviceplugin/proto/deviceplugin.proto

# ----------------------------------------------------------------- native

.PHONY: native
native:  ## Build libtpuslice.so + its C++ test binary
	$(MAKE) -C native

.PHONY: native-test
native-test: native
	native/build/tpuslice_test

# ------------------------------------------------------------------ tests

.PHONY: lint
lint:  ## Project-invariant static analysis (docs/STATIC_ANALYSIS.md): zero tolerance — any finding fails the build
	$(PY) tools/slicelint.py

.PHONY: check
check: lint  ## Both static gates: slicelint (per-file idiom) + slicecheck (whole-program guarded-by + dispatch hygiene, docs/STATIC_ANALYSIS.md) — zero tolerance
	$(PY) tools/slicecheck.py

.PHONY: test
test: check  ## Fast tier (~2 min): slicelint gate, control plane, device, kube, topology — then the trace-check + events-check + telemetry-smoke + profile-smoke observability gates and the bench-smoke + bench-defrag-smoke + bench-serving-smoke + bench-engine-smoke + bench-prefix-smoke + bench-spec-smoke + bench-router-smoke floors
	$(PY) -m pytest tests/ -x -q -m "not slow"
	$(MAKE) trace-check
	$(MAKE) events-check
	$(MAKE) telemetry-smoke
	$(MAKE) profile-smoke
	$(MAKE) chaos-crash-smoke
	$(MAKE) chaos-partition-smoke
	$(MAKE) bench-smoke
	$(MAKE) bench-defrag-smoke
	$(MAKE) bench-serving-smoke
	$(MAKE) bench-engine-smoke
	$(MAKE) bench-prefix-smoke
	$(MAKE) bench-spec-smoke
	$(MAKE) bench-router-smoke

.PHONY: telemetry-smoke
telemetry-smoke:  ## <60 s fleet-telemetry gate (docs/OBSERVABILITY.md "Fleet telemetry"): 2-replica fleet behind the router + aggregator on a pinned clock, clean AND under one seeded delay-only fault plan — aggregator rollups reconcile EXACTLY with the loadgen client report and the journal counters, burn-rate High fires under the injected-latency arm and Clears on heal, a capacity-blocked request stitches a >=3-component timeline via the caused-by link, zero hung
	JAX_PLATFORMS=cpu timeout -k 10 300 $(PY) tools/telemetry_smoke.py

.PHONY: profile-smoke
profile-smoke:  ## <60 s continuous-profiler gate (docs/OBSERVABILITY.md "Profiling"): serve + loadgen with the profiler armed — tok/s >= 0.95x the unprofiled arm, profiler ring == scheduler round counter == profile_rounds metric with zero ring growth after quiesce, exported Chrome trace valid with >=1 full round lane, >=1 request waterfall stitched, zero mid-traffic CompileObserved after warmup
	JAX_PLATFORMS=cpu timeout -k 10 300 $(PY) tools/profile_smoke.py

.PHONY: bench-trend
bench-trend:  ## Bench-record trend report + regression gate: reads every BENCH*_rNN.json tier, prints the headline series, exits non-zero when the newest record of a tier regresses >10% vs the best prior record of that tier
	$(PY) tools/bench_trend.py

.PHONY: chaos-crash-smoke
chaos-crash-smoke:  ## <60 s crash-consistency gate (docs/RECOVERY.md): one controller kill mid-fan-out + one agent kill mid-realize + one serving-replica kill mid-stream, each under load — every pod granted, zero double-allocations, zero orphaned device slices, zero hung requests, chains legal across restart epochs
	JAX_PLATFORMS=cpu timeout -k 10 300 $(PY) -m pytest tests/test_crash_chaos.py -q -k "smoke" -p no:cacheprovider

.PHONY: chaos-partition-smoke
chaos-partition-smoke:  ## <60 s partition-tolerance gate (docs/RECOVERY.md "Partitions & gray failures"): partition the controller -> failover -> heal -> converge with zero double-allocations; agent static mode across a cut; eject a 100%-success gray replica on latency EWMA -> sessions migrate -> re-admit after heal — nemesis invariant checker strict, zero hung requests
	JAX_PLATFORMS=cpu timeout -k 10 300 $(PY) -m pytest tests/test_partition_chaos.py -q -k "smoke" -p no:cacheprovider

.PHONY: bench-smoke
bench-smoke:  ## <60 s shrunken scale run (sharded workers + informer plane on a fleet sim): asserts a grants/sec floor and zero reconcile errors (TPUSLICE_SMOKE_FLOOR/NODES/PODS to tune)
	JAX_PLATFORMS=cpu $(PY) bench.py --smoke

.PHONY: bench-defrag-smoke
bench-defrag-smoke:  ## <60 s churn run: fragment a group, assert the repacker recovers the utilization floor (TPUSLICE_DEFRAG_FLOOR), grants every blocked pod, and keeps every transition chain legal (events-check strict)
	JAX_PLATFORMS=cpu $(PY) bench.py --defrag-smoke

.PHONY: bench-defrag
bench-defrag:  ## Full defrag tier: frag-aware + repacker vs first-fit-no-repack (capacity utilization, NoCapacity-wait p95) plus the mid-migration chaos arm (docs/SCALING.md)
	JAX_PLATFORMS=cpu $(PY) bench.py --defrag

.PHONY: bench-serving-smoke
bench-serving-smoke:  ## <60 s mixed-SLO serving run over the continuous scheduler: asserts latency-class SLO attainment ≥ TPUSLICE_SERVING_SLO_FLOOR, paged kv utilization ≥ TPUSLICE_SERVING_KV_FLOOR (and > the legacy stripe metric), zero hung requests
	JAX_PLATFORMS=cpu $(PY) bench.py --serving-smoke

.PHONY: bench-serving
bench-serving:  ## Full serving tier: continuous-batching scheduler vs the fixed-decode-round baseline on the mixed-SLO multi-tenant scenario (tok/s, per-class TTFT p95, SLO attainment, paged-vs-legacy kv utilization) — records BENCH_SERVING_r09.json (docs/SERVING.md)
	JAX_PLATFORMS=cpu $(PY) bench.py --serving

.PHONY: bench-engine-smoke
bench-engine-smoke:  ## <60 s bursty-admission run of both engine arms: asserts hot-path (batched prefill + overlap) tok/s >= TPUSLICE_ENGINE_FLOOR x the per-slot baseline, zero hung requests, preempt/resume ledger reconciling
	JAX_PLATFORMS=cpu $(PY) bench.py --engine-smoke

.PHONY: bench-engine
bench-engine:  ## Full engine hot-path tier: batched-prefill + overlap arm vs the per-slot PR 9 baseline, best-of-3 per arm (tok/s AND TTFT p95 must both win) — records BENCH_ENGINE_r10.json (docs/SERVING.md)
	JAX_PLATFORMS=cpu $(PY) bench.py --engine

.PHONY: bench-prefix-smoke
bench-prefix-smoke:  ## <60 s shared-prefix run of both arms: asserts radix tok/s >= TPUSLICE_PREFIX_FLOOR (0.9, a regression floor — the recorded bench-prefix tier gates the strict win) x the exact-match baseline, prefix-hit token savings > 0, ledgers reconciling, zero leaked blocks after quiesce
	JAX_PLATFORMS=cpu $(PY) bench.py --prefix-smoke

.PHONY: bench-prefix
bench-prefix:  ## Full radix prefix-cache tier: radix arm vs exact-match-only baseline on the seeded shared-prefix workload, best-of-3 per arm (tok/s AND TTFT p95 must both win) — records BENCH_PREFIX_r11.json (docs/SERVING.md)
	JAX_PLATFORMS=cpu $(PY) bench.py --prefix

.PHONY: bench-spec-smoke
bench-spec-smoke:  ## <60 s speculative-decoding run of both arms at temperature>0: asserts spec tok/s >= TPUSLICE_SPEC_FLOOR (0.9, a regression floor — the recorded bench-spec tier gates the strict win) x the no-spec baseline, real draft acceptance, ledgers reconciling with zero leaked blocks/locks after quiesce, compiled programs <= budget
	JAX_PLATFORMS=cpu $(PY) bench.py --spec-smoke

.PHONY: bench-spec
bench-spec:  ## Full speculative-decoding tier: spec arm (rejection sampling + adaptive k + overlapped rounds) vs the no-spec baseline at temperature 0 AND >0, best-of-4 interleaved (tok/s AND TTFT p95 must both win at both temperatures) — records BENCH_SPEC_r12.json (docs/SERVING.md)
	JAX_PLATFORMS=cpu $(PY) bench.py --spec

.PHONY: bench-router-smoke
bench-router-smoke:  ## <60 s 2-replica fleet gate: router aggregate tok/s >= TPUSLICE_ROUTER_FLOOR (0.5, a meltdown floor; the deterministic gates are prefix routing firing, the migration probe, and clean ledgers — the recorded tier gates the capacity win) x the single replica on the identical recorded->replayed stream, one live KV session migration token-identical, zero hung, ledgers reconcile on both replicas
	JAX_PLATFORMS=cpu $(PY) bench.py --router-smoke

.PHONY: bench-router
bench-router:  ## Full fleet-router tier: 3-replica router vs best single replica on the identical recorded->replayed stream (fleet wins tok/s by TPUSLICE_ROUTER_RECORD_FLOOR with TTFT p95 no worse; the one-core CI box measures the prefix-capacity mechanism — see docs/SERVING.md) + churn arm (replica kill/re-add mid-run, migrated sessions oracle-exact, ledgers clean) — records BENCH_ROUTER_r13.json
	JAX_PLATFORMS=cpu $(PY) bench.py --router

.PHONY: bench-scale
bench-scale:  ## Fleet-scale control-plane bench: 1k nodes / 2k pending pods, grants/sec + gate→ungate p95/p99, with the serial re-list baseline ratio (docs/SCALING.md)
	JAX_PLATFORMS=cpu $(PY) bench.py --scale --scale-baseline

.PHONY: trace-check
trace-check:  ## Observability gate: drive the sim + a short loadgen with TPUSLICE_TRACE_FILE set, then validate the JSONL (unparseable lines, negative durations, orphan spans, broken trace propagation)
	@f=$$(mktemp -u /tmp/tpuslice-trace-check.XXXXXX.jsonl); \
	  echo "trace-check: $$f"; \
	  JAX_PLATFORMS=cpu $(PY) tools/validate_trace.py --drive $$f \
	    && rm -f $$f

.PHONY: events-check
events-check:  ## Flight-recorder gate: drive the sim (one clean grant + one injected-fault retry) and a serving drain cycle with TPUSLICE_EVENT_FILE set, then validate the journal (ordered transition chains, trace-id links, reason catalog, describe-pod rendering)
	@f=$$(mktemp -u /tmp/tpuslice-events-check.XXXXXX.jsonl); \
	  echo "events-check: $$f"; \
	  JAX_PLATFORMS=cpu $(PY) tools/validate_events.py --drive $$f \
	    && rm -f $$f

.PHONY: test-all
test-all:  ## Everything, incl. jax-workload + multi-process tiers (~19 min)
	$(PY) -m pytest tests/ -x -q

.PHONY: test-e2e
test-e2e:  ## Full in-process cluster lifecycle tier
	$(PY) -m pytest tests/test_e2e_lifecycle.py -q

.PHONY: test-e2e-kind
test-e2e-kind:  ## Real-cluster e2e on KinD (skips cleanly without docker/kind)
	./deploy/e2e_kind.sh

.PHONY: chaos
chaos:  ## Control-plane + serving + crash-consistency chaos tiers across 3 seeds (hung tests dump all thread stacks via faulthandler before the outer timeout kills them). The crash arm kill-loops every crash point (docs/RECOVERY.md). TPUSLICE_LOCKCHECK=1 arms the lock-order race detector: any ABBA cycle observed during the run fails the session (docs/STATIC_ANALYSIS.md)
	@set -e; for seed in 1 2 3; do \
	  echo "=== chaos seed $$seed ==="; \
	  CHAOS_SEED=$$seed CHAOS_DURATION=$${CHAOS_DURATION:-8} \
	  PYTEST_FAULTHANDLER_SESSION_TIMEOUT=330 \
	  JAX_PLATFORMS=cpu \
	  timeout -k 10 360 $(PY) -m pytest \
	    tests/test_chaos.py tests/test_serving_chaos.py \
	    tests/test_crash_chaos.py tests/test_partition_chaos.py -q; \
	done

.PHONY: bench
bench:  ## Headline benchmark: slice-grant p50 latency (one JSON line)
	$(PY) bench.py

.PHONY: verify-manifests
verify-manifests:  ## Fail if checked-in CRD yaml drifted from the code
	$(PY) tools/gen_manifests.py --check

.PHONY: gpu-manifests
gpu-manifests:  ## Render the PyTorch/CUDA port's deploy plane (instaslice_tpu_torch/deploy/config + samples) from instaslice_tpu_torch.deploy.manifests
	$(PY) -m instaslice_tpu_torch.deploy.gen_manifests

.PHONY: gpu-verify-manifests
gpu-verify-manifests:  ## Fail if the port's checked-in deploy tree drifted from the code
	$(PY) -m instaslice_tpu_torch.deploy.gen_manifests --check

.PHONY: gpu-lint
gpu-lint:  ## The PyTorch/CUDA port's slicelint (instaslice_tpu_torch/analysis/slicelint.py, the reference's rules over the port): zero tolerance
	$(PY) -m instaslice_tpu_torch.analysis.slicelint

.PHONY: gpu-check
gpu-check: gpu-lint  ## The port's two static gates: slicelint + slicecheck (guarded-by, balanced pairs, torch dispatch hygiene incl. unbudgeted-graph) — zero tolerance
	$(PY) -m instaslice_tpu_torch.analysis.slicecheck

.PHONY: gpu-trace-check
gpu-trace-check:  ## The port's trace gate on the CPU: its sim grants a 1g.10gb slice on an H100 node + a loadgen burst on its server with TPUSLICE_TRACE_FILE set, then validate the JSONL and the propagation contract
	@f=$$(mktemp -u /tmp/tpuslice-gpu-trace-check.XXXXXX.jsonl); \
	  echo "gpu-trace-check: $$f"; \
	  timeout -k 10 300 $(PY) -m instaslice_tpu_torch.analysis.validate_trace \
	    --drive --device cpu $$f && rm -f $$f

.PHONY: gpu-events-check
gpu-events-check:  ## The port's flight-recorder gate on the CPU: a clean grant + an injected-fault retry in its sim, describe pod, a drain cycle on its server with TPUSLICE_EVENT_FILE set; chains strict, reason catalog
	@f=$$(mktemp -u /tmp/tpuslice-gpu-events-check.XXXXXX.jsonl); \
	  echo "gpu-events-check: $$f"; \
	  timeout -k 10 300 $(PY) -m instaslice_tpu_torch.analysis.validate_events \
	    --drive --device cpu $$f && rm -f $$f

.PHONY: gpu-telemetry-smoke
gpu-telemetry-smoke:  ## The port's fleet-telemetry gate on the CPU: 2 replicas behind its router + its aggregator on a pinned clock, clean and under a delay-only fault plan (exact rollups, burn High/Clear, a >=3-component caused-by timeline, zero hung)
	timeout -k 10 300 $(PY) -m instaslice_tpu_torch.analysis.telemetry_smoke --device cpu

.PHONY: gpu-profile-smoke
gpu-profile-smoke:  ## The port's profiler gate on the CPU: armed tok/s >= 0.95x unprofiled, ring == round counter == profile_rounds, Chrome trace with a dispatch segment, a waterfall, no compile past warm-up
	timeout -k 10 300 $(PY) -m instaslice_tpu_torch.analysis.profile_smoke --device cpu

.PHONY: gpu-chaos-crash-smoke
gpu-chaos-crash-smoke:  ## The port's crash gate on the CPU (<60 s): a controller killed mid-fan-out and an agent mid-realize on its sim's H100 nodes, a serving replica killed mid-stream under its router; every pod granted, zero double allocations, zero orphaned slices, chains legal across restarts, zero hung
	timeout -k 10 300 $(PY) -m instaslice_tpu_torch.analysis.chaos_smoke --crash --device cpu

.PHONY: gpu-chaos-partition-smoke
gpu-chaos-partition-smoke:  ## The port's partition gate on the CPU (<60 s): the controller cut from the apiserver and healed, an agent in static mode across a cut, a gray replica ejected on latency EWMA and re-admitted, then the loadgen's nemesis arm; check_nemesis and strict chains clean, zero hung
	timeout -k 10 300 $(PY) -m instaslice_tpu_torch.analysis.chaos_smoke --partition --device cpu

.PHONY: gpu-chaos
gpu-chaos:  ## The port's chaos tiers across 3 seeds under TPUSLICE_LOCKCHECK=1 (a lock-order cycle fails a module): randomized ops on its sim, serving faults, the crash tier (kill loop over every crash site, watchdogs) and the partition tier
	@set -e; for seed in 1 2 3; do \
	  echo "=== gpu-chaos seed $$seed ==="; \
	  CHAOS_SEED=$$seed CHAOS_DURATION=$${CHAOS_DURATION:-8} \
	  TPUSLICE_LOCKCHECK=1 \
	  PYTEST_FAULTHANDLER_SESSION_TIMEOUT=330 \
	  JAX_PLATFORMS=cpu \
	  timeout -k 10 360 $(PY) -m pytest \
	    tests/test_torch_chaos.py tests/test_torch_serving_chaos.py \
	    tests/test_torch_crash_chaos.py tests/test_torch_partition_chaos.py \
	    -q -p no:cacheprovider; \
	done

.PHONY: gpu-test-deploy
gpu-test-deploy:  ## The port's deploy-plane validation without a cluster: apply the rendered tree over HTTP to the port's fake apiserver, cross-check references and GPU-node needs, lint the port's Dockerfiles against pyproject scripts
	$(PY) -m instaslice_tpu_torch.deploy.check

# ----------------------------------------------------------------- images

.PHONY: docker-build
docker-build:  ## Controller, agent, and device-plugin images
	docker build -f Dockerfile.controller -t $(IMG_PREFIX)-controller:$(TAG) .
	docker build -f Dockerfile.agent -t $(IMG_PREFIX)-agent:$(TAG) .
	docker build -f Dockerfile.deviceplugin -t $(IMG_PREFIX)-deviceplugin:$(TAG) .

.PHONY: gpu-docker-build
gpu-docker-build:  ## The PyTorch/CUDA port's controller, agent and device-plugin images (no PyTorch in any)
	docker build -f instaslice_tpu_torch/deploy/Dockerfile.controller -t $(IMG_PREFIX)-gpu-controller:$(TAG) .
	docker build -f instaslice_tpu_torch/deploy/Dockerfile.agent -t $(IMG_PREFIX)-gpu-agent:$(TAG) .
	docker build -f instaslice_tpu_torch/deploy/Dockerfile.deviceplugin -t $(IMG_PREFIX)-gpu-deviceplugin:$(TAG) .

.PHONY: build-images
build-images:  ## Build the images with whatever builder exists; without one, execute the Dockerfiles' build steps on the host and log the proof (deploy/docker-build.log)
	$(PY) tools/build_images.py

# ----------------------------------------------------------------- deploy

.PHONY: install
install: manifests  ## Install the TpuSlice CRD
	$(KUBECTL) apply -f config/crd/bases/

.PHONY: uninstall
uninstall:
	$(KUBECTL) delete -f config/crd/bases/ --ignore-not-found

.PHONY: deploy
deploy: install  ## CRD + RBAC + controller/agent/device-plugin workloads
	$(KUBECTL) apply -k config/default

.PHONY: undeploy
undeploy:
	$(KUBECTL) delete -k config/default --ignore-not-found

.PHONY: test-deploy
test-deploy:  ## Deploy-plane validation without a cluster: render config/default, apply over HTTP to the fake apiserver, cross-check selectors/SAs/ports, lint Dockerfiles against pyproject scripts
	$(PY) tools/test_deploy.py > deploy/test-deploy.log 2>&1; \
	  st=$$?; cat deploy/test-deploy.log; exit $$st
