from turtlevsr_tpu_torch.config.options import (  # noqa: F401
    LevelSpec,
    ModelConfig,
    OptionsError,
    dict2str,
    load_options,
    model_config_from_options,
)
