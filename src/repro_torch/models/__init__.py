"""LM backbones and the late-interaction encoder: the dense decoder
(``transformer``), its layers and KV caches, the ColBERT head
(``colbert.encode_tokens``) and weight conversion from the JAX package's
parameter pytrees (``convert``). Plain PyTorch: the JAX package computes
these outside any Pallas kernel."""
