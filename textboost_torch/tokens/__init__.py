"""Token surgery (a copy of textboost_tpu/tokens)."""
