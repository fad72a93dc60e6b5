from dsp_tpu_torch.chain.chain import (
    Chain,
    ChainError,
    CompiledChain,
    build_chain_from_args,
    build_chain_from_file,
    build_chain_from_string,
)

__all__ = [
    "Chain",
    "ChainError",
    "CompiledChain",
    "build_chain_from_args",
    "build_chain_from_file",
    "build_chain_from_string",
]
