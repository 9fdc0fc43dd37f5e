"""The device-parity sweep's cases of presets and workflows, on the CPU.

Each case of ``tests/torch_device_cases.py`` in this layer runs on the
CPU with finite outputs, bitwise equal when run again with the same seed;
each card case's default call (numpy in, no ``device=``) raises the CUDA
error here, where there is no card, and each host case's default call runs.
The card's half of the sweep: ``tests/test_torch_gpu_device_cases.py`` and
``chip_smoke.py``'s phase R.
"""

import torch
from torch_device_cases import cpu_tests

torch.set_num_threads(1)

test_case_runs_on_the_cpu_and_repeats, test_default_call_goes_to_the_card = cpu_tests("presets")
