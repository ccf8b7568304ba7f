# Top-level build/test driver (the reference used CMake + ctest;
# here the Python package needs no build and the native library is one
# translation unit).

.PHONY: all native test test-gpu bench check check-chip chip-smoke clean

all: native

native:
	$(MAKE) -C native

test: native
	python -m pytest tests/ -q

# On a machine with an NVIDIA GPU: the tests marked `gpu` (compiled
# kernels) on the card.
test-gpu: native
	WARPDB_TEST_GPU=1 python -m pytest tests/ -q -m gpu

bench: native
	python bench.py

# Pre-snapshot gate (VERDICT r3 #9): the FULL suite, the TPC-H oracle
# run, and a bench smoke that fails on any *_error key.  CI runs this;
# no snapshot commit may be taken with it red.
check: native
	python -m pytest tests/ -q
	python scripts/check_gate.py

# Chip leg of the gate (VERDICT r4 #1c), on a GPU: the full bench must
# be green — no *_error keys, no roofline violations against the
# device-kind HBM peak (warpdb_tpu/utils/metrics.py).  `make check`
# alone cannot see chip-only failures (it forces the CPU backend).
check-chip: native
	python scripts/check_bench_chip.py

# The end-to-end smoke run on one GPU (chip_smoke.py --help).
chip-smoke: native
	python chip_smoke.py

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} +
