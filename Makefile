# One-command CI entry — parity with the reference's Travis build+ctest
# matrix.  `make check` reproduces the green state on the CPU: native build,
# full pytest suite (8-device virtual CPU mesh), the multi-device dry run,
# example smoke runs, and the chip_smoke rehearsal.  On a machine with an
# NVIDIA GPU, `python chip_smoke.py` is the one command to run.

PY ?= python
CPU_ENV = JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

.PHONY: check test native dryrun examples rehearse clean

check: native test dryrun examples rehearse
	@echo "ALL CHECKS PASSED"

native:
	$(MAKE) -C native

test:
	$(CPU_ENV) $(PY) -m pytest tests/ -q

dryrun:
	$(CPU_ENV) $(PY) -c "import jax; jax.config.update('jax_platforms','cpu'); import __graft_entry__ as g; g.dryrun_multichip(8, interpret=True)"

examples:
	$(CPU_ENV) $(PY) examples/quickstart.py --quick
	$(CPU_ENV) $(PY) examples/thesis_hmm_comparison.py --quick
	$(CPU_ENV) $(PY) examples/calo_variance.py -n 4
	$(CPU_ENV) $(PY) examples/sherpa_gen.py -n 2 --out /tmp/sherpa_smoke
	$(CPU_ENV) $(PY) examples/sherpa_fullscale.py --quick
	$(CPU_ENV) $(PY) examples/external_simulator.py --traces 300 \
	    --particles 64 --out /tmp/external_smoke.json
	$(CPU_ENV) $(PY) examples/posterior_parse_bench.py --particles 16384 \
	    --out /tmp/parse_smoke.json

rehearse:
	$(PY) chip_smoke.py --rehearse

clean:
	$(MAKE) -C native clean || true
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
