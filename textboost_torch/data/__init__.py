"""Host-side data: tokenizer, prompt banks, datasets and the batch loader."""
