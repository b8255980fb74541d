"""qwen2: the llama block, with NEOX RoPE and q / k / v biases from its configuration."""

from benchmark.archs.llama import block, cost, tensors  # noqa: F401
