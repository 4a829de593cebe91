# Convenience targets (the reference's root Makefile builds one binary;
# here the "binary" is the Python package + native library).

.PHONY: all native test selftest smoke bench sanitize clean

all: native

native:
	$(MAKE) -C native

test: native
	python -m pytest tests/ -q

selftest: native
	python3 -m rtlsdr_ft8d_jax.host.cli -t

smoke: native
	python3 chip_smoke.py

bench: native
	python3 bench.py

# ASan+UBSan run of the native library under the real test suite: every
# test that crosses the ctypes boundary (codec parity + fuzz, IPFIX wire
# format, ingest ring, OSD batch) executes against the sanitized build.
# detect_leaks=0: CPython interns/arenas report as leaks; the target is
# heap-buffer/UB errors in libft8d, which abort the run
# (-fno-sanitize-recover=all). Pure-Python fallbacks are disabled so a
# load failure cannot silently pass (FT8D_REQUIRE_NATIVE=1).
# libstdc++ must be preloaded with libasan: python doesn't link it, so
# ASan's __cxa_throw interceptor would otherwise be uninitialized and
# jaxlib's first C++ throw aborts the interpreter.
SANITIZE_TESTS = tests/test_native.py tests/test_fuzz_parity.py \
  tests/test_fuzz_edges.py tests/test_osd.py tests/test_host.py \
  tests/test_protocol_tables.py
sanitize:
	$(MAKE) -C native asan
	@for lib in libasan.so libstdc++.so; do \
	  p="$$($(CXX) -print-file-name=$$lib)"; \
	  case "$$p" in /*) test -e "$$p" || { echo "error: $$lib resolved to missing $$p" >&2; exit 1; };; \
	  *) echo "error: $$lib not found by $(CXX) (got '$$p') — install gcc sanitizer runtime" >&2; exit 1;; \
	  esac; \
	done
	LD_PRELOAD="$$($(CXX) -print-file-name=libasan.so) $$($(CXX) -print-file-name=libstdc++.so)" \
	ASAN_OPTIONS=detect_leaks=0:abort_on_error=1 \
	UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1 \
	FT8D_NATIVE_SO=$(CURDIR)/native/libft8d_asan.so \
	FT8D_REQUIRE_NATIVE=1 \
	python -m pytest $(SANITIZE_TESTS) -q

clean:
	$(MAKE) -C native clean 2>/dev/null || rm -f native/libft8d.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
