"""LoRA adapter and token-embedding artifacts (PEFT / textual-inversion formats)."""
