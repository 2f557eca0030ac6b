# Convenience targets (see .github/workflows/ci.yml for the CI equivalent)
PY ?= python

# CPU suite; xdist's per-file workers (--dist loadfile) isolate the files
test:
	$(PY) -m pytest tests/ -q -m 'not slow' -p xdist -n 6 --dist loadfile

# the GPU smoke run (needs a GPU; exits 2 without one)
smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

native:
	$(MAKE) -C native

clean:
	$(MAKE) -C native clean

.PHONY: test smoke bench native clean
