"""flash_attention: online-softmax attention, causal or full, with GQA."""
