from .masks import compile_masks, CompiledMasks
