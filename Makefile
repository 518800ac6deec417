# Developer entry points (see CLAUDE.md for environment notes).

.PHONY: test test-fast bench bench-latency serve native clean \
	serve-torch test-torch smoke bench-torch bench-torch-latency

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/ -q \
	  --ignore=tests/test_video_parity.py \
	  --ignore=tests/test_flow.py \
	  --ignore=tests/test_streaming.py \
	  --ignore=tests/test_reference_differential.py \
	  --ignore=tests/test_odd_inputs.py

bench:
	python bench.py

bench-latency:
	AVD_BENCH_MODE=latency python bench.py

serve:
	python -m avd_tpu.serve.master

native:
	$(MAKE) -C avd_tpu/native/src

# the PyTorch/CUDA port (avd_tpu_torch)
serve-torch:
	python -m avd_tpu_torch.serve.master --device cuda

test-torch:
	python -m pytest tests/test_torch_*.py -q

# the port's bench on the card (DEVICE=cpu runs the plain versions)
bench-torch:
	python -m avd_tpu_torch.bench $(if $(DEVICE),--device $(DEVICE))

bench-torch-latency:
	AVD_BENCH_MODE=latency python -m avd_tpu_torch.bench \
	  $(if $(DEVICE),--device $(DEVICE))

smoke:
	python3 chip_smoke.py

clean:
	$(MAKE) -C avd_tpu/native/src clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
