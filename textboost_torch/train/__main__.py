"""`python -m textboost_torch.train`: see textboost_torch/train/__init__.py."""
from . import main

if __name__ == "__main__":
    main()
