"""LM backbones, the late-interaction encoder and the recsys zoo: the
decoder (``transformer``, dense or with routed MoE FFNs from ``moe``), its
layers and KV caches, the ColBERT head (``colbert.encode_tokens``), FM /
AutoInt / DIN / SASRec (``recsys``) and weight conversion from the JAX
package's parameter pytrees (``convert``). Plain PyTorch: the JAX package
computes these outside any Pallas kernel."""
