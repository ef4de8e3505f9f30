"""Serving: prefill + decode with dense and SZx-planes KV caches (``engine``)."""
