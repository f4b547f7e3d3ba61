"""The dense decoder family (Qwen2, Qwen3): an attention and an MLP a
layer, every layer under ``stack/pos_0``; also the family of a
configuration that names none.  Its functions are the benchmark's own,
unchanged."""
from portbench.families import model_config
from portbench.reference.model import logits, logits_stepwise
from portbench.weights import layer_params, program_tree, top_params

__all__ = ["model_config", "program_tree", "top_params", "layer_params",
           "keeps_layer_weights", "logits", "logits_stepwise",
           "ap_graphs_per_step"]


def keeps_layer_weights(model: dict) -> bool:
    return model["n_layers"] * model["d_model"] * model["d_ff"] < 2 ** 28


def ap_graphs_per_step(model: dict) -> int:
    """Every MLP as two AP graphs (gate and up, then down)."""
    return 2 * model["n_layers"]
