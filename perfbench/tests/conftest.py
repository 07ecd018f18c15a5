"""Keep each test process to two CPU threads: the tests run whole tiny
cells side by side."""

import torch

torch.set_num_threads(2)
