.PHONY: test test-all test-fast smoke bench native clean

# default tier: everything but the multi-minute trajectory/golden runs
# (~5-8 min); test-all adds the @pytest.mark.slow tier (~1 h)
test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow"

test-all:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

test-fast:
	JAX_PLATFORMS=cpu python -m pytest tests/test_config.py tests/test_grid.py \
	  tests/test_grains.py tests/test_io.py tests/test_native.py \
	  tests/test_gmres.py -q

# on a machine with an NVIDIA GPU: kernels vs XLA at the flagship geometry,
# parity in f64, and the main path through the CLI (see chip_smoke.py)
smoke:
	python chip_smoke.py

bench:
	python bench.py

native:
	$(MAKE) -C native

clean:
	$(MAKE) -C native clean
	rm -rf output output_* __pycache__ */__pycache__
