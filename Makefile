# Top-level entry points.
#
#   make test        - full pytest suite (CPU f64, virtual 8-device mesh)
#   make test-fast   - non-slow suite, 2 pytest-xdist workers (fast, but
#                      this platform's XLA:CPU occasionally crashes a
#                      long-lived worker mid-compile -- see
#                      tests/conftest.py; rerun or use test-files)
#   make test-files  - non-slow suite, one pytest process PER FILE: slow
#                      but immune to the long-lived-process compiler
#                      crash (the reliable local recipe)
#   make runtime     - build the native C++ runtime library
#   make bench       - GPU benchmark (one JSON line on stdout)

.PHONY: test test-fast test-files runtime bench

test: runtime
	python -m pytest tests/ -q

test-fast: runtime
	python -m pytest tests/ -q -m "not slow" -n 2 --dist loadfile

test-files: runtime
	@fail=0; for f in tests/test_*.py; do \
	  python -m pytest $$f -q -m "not slow" || fail=1; \
	done; exit $$fail

runtime:
	$(MAKE) -C runtime

bench:
	python bench.py
