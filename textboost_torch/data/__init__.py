"""Host-side data helpers (tokenizer)."""
