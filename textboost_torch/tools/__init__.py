"""Tools of the port: `python -m textboost_torch.tools.paper_protocol` and
`python -m textboost_torch.tools.gen_null_emb`."""
