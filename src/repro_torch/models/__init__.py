"""The LM substrate's serving path on torch tensors: layers, GQA attention
(K4 for prefill) and a dense decoder (``transformer``)."""
