"""Checkpoint transports: :mod:`peer_snapshot`'s chunked write-once blob
transport, which KV-block migration publishes through."""
