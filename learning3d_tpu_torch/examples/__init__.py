"""The port's command-line entry points, twins of the JAX package's
``examples/train.py`` and ``examples/evaluate.py``:

    python -m learning3d_tpu_torch.examples.train --model pointnet --task classification
    python -m learning3d_tpu_torch.examples.evaluate --model pointnet --ckpt exp_pointnet --quantize

Both take the JAX scripts' flags with their defaults, plus ``--device``
("cuda" unless the caller asks for the CPU)."""
