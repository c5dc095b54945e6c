"""The benchmark of the PyTorch/CUDA port (``mirror_maze_tpu_torch``) on an
NVIDIA H100: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See portbench/run.py."""
