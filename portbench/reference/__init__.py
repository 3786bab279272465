"""The benchmark's plain references, frozen with the benchmark.

Copies of the port's plain PyTorch modules (the ViT, MoGe, DepthPro35, the
geometry and the labelling program) that import nothing of the port and
no kernel: attention is `attention.py`'s plain softmax. Built with float32
configs and run under `precision.full_f32()`, they are what the cells'
outputs are compared with; under `precision.lower(...)` they are the
control. `train.py` is the fine-tuning step's plain loss and AdamW.
"""
