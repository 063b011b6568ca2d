"""The plain reference that decides ``correct``: PyTorch operations only,
float32 (TF32 off, which the caller sets), no kernels, no cache, no
batching. It imports nothing of the program: each network is written
here from its published description (``nets.py``), the augmentation
from its definition (``augment.py``), the adversarial step and Adam from
theirs (``train.py``), and the served forward from the model
(``serve.py``). Weights come from the benchmark as name -> tensor maps
whose names and shapes ``nets.py`` defines.
"""
