# Local mirrors of the CI gates (.github/workflows/ci.yml).
#   make lint         — tier 0: reprolint, the static contract gate (seconds)
#   make test         — tier 1: fast pytest suite (slow marker deselected)
#   make slow         — tier 2: the long end-to-end suite
#   make check        — tier 0 then tier 1, the pre-commit sequence
#   make report       — combined markdown+CSV table over every BENCH_*.json
#   make resume-smoke — kill-and-resume bit-identity: a 2-round train run
#                       vs the same run aborted after round 1 and resumed;
#                       the final state checkpoints must be byte-identical
#   make trace-smoke  — telemetry end-to-end: a tiny fault-injected train
#                       run with --trace-dir, then a schema check over the
#                       emitted trace.json / metrics.jsonl / manifest.json

PY ?= python

.PHONY: lint test slow check report resume-smoke trace-smoke

lint:
	$(PY) -m tools.reprolint src tests benchmarks examples

test:
	PYTHONPATH=src $(PY) -m pytest -x -q

slow:
	PYTHONPATH=src $(PY) -m pytest -m slow

check: lint test

report:
	$(PY) -m tools.bench_report --csv BENCH_report.csv

# tiny but REAL: static channel + erasures + crashes, so the resumed run
# must also replay the fault stream exactly to pass the bitwise diff
RESUME_ARGS = --rounds 2 --clients 2 --seq 32 --micro 1 --local-steps 1 \
	--channel static --erasure-prob 0.3 --crash-hazard 0.2 --ckpt-every 1

resume-smoke:
	rm -rf /tmp/resume_smoke && mkdir -p /tmp/resume_smoke
	PYTHONPATH=src $(PY) -m repro.launch.train $(RESUME_ARGS) \
		--ckpt-dir /tmp/resume_smoke/full
	PYTHONPATH=src $(PY) -m repro.launch.train $(RESUME_ARGS) \
		--ckpt-dir /tmp/resume_smoke/killed --abort-after 1
	PYTHONPATH=src $(PY) -m repro.launch.train $(RESUME_ARGS) \
		--ckpt-dir /tmp/resume_smoke/killed --resume
	$(PY) -m tools.ckpt_diff /tmp/resume_smoke/full/state \
		/tmp/resume_smoke/killed/state

trace-smoke:
	rm -rf /tmp/trace_smoke
	PYTHONPATH=src $(PY) -m repro.launch.train $(RESUME_ARGS) \
		--trace-dir /tmp/trace_smoke
	PYTHONPATH=src $(PY) tools/check_trace.py /tmp/trace_smoke

# The PyTorch port's mirrors of resume-smoke and trace-smoke: the same
# RESUME_ARGS through repro_torch.launch.train on the card (PORT_DEVICE=cpu
# to run them on the CPU), into the git-ignored build/ directory.
#   make port-resume-smoke — the final state checkpoints of the whole and
#                            the killed-and-resumed run, byte-identical
#                            (tools.port_ckpt_diff)
#   make port-trace-smoke  — tools/check_trace.py over the --trace-dir run,
#                            tools.port_check_spans over its spans.json
PORT_DEVICE ?= cuda
PORT_SMOKE = build/port_smoke

.PHONY: port-resume-smoke port-trace-smoke

port-resume-smoke:
	rm -rf $(PORT_SMOKE)/resume && mkdir -p $(PORT_SMOKE)/resume
	PYTHONPATH=src $(PY) -m repro_torch.launch.train $(RESUME_ARGS) \
		--device $(PORT_DEVICE) --ckpt-dir $(PORT_SMOKE)/resume/full
	PYTHONPATH=src $(PY) -m repro_torch.launch.train $(RESUME_ARGS) \
		--device $(PORT_DEVICE) --ckpt-dir $(PORT_SMOKE)/resume/killed \
		--abort-after 1
	PYTHONPATH=src $(PY) -m repro_torch.launch.train $(RESUME_ARGS) \
		--device $(PORT_DEVICE) --ckpt-dir $(PORT_SMOKE)/resume/killed \
		--resume
	$(PY) -m tools.port_ckpt_diff $(PORT_SMOKE)/resume/full/state \
		$(PORT_SMOKE)/resume/killed/state

port-trace-smoke:
	rm -rf $(PORT_SMOKE)/trace
	PYTHONPATH=src $(PY) -m repro_torch.launch.train $(RESUME_ARGS) \
		--device $(PORT_DEVICE) --trace-dir $(PORT_SMOKE)/trace
	PYTHONPATH=src $(PY) tools/check_trace.py $(PORT_SMOKE)/trace
	$(PY) -m tools.port_check_spans $(PORT_SMOKE)/trace/spans.json
