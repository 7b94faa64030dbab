"""``python -m horovod_tpu_torch.run -np N [-H hosts] command...``: the
port's hvdrun (``run/cli.py``)."""

from .cli import main

if __name__ == "__main__":
    main()
