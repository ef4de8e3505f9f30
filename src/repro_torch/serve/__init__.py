"""Serving: prefill + decode with dense and SZx-planes KV caches (``engine``),
and the HTTP store service (``service``, ``store_service``, ``client``)."""
