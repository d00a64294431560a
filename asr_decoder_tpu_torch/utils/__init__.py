from asr_decoder_tpu_torch.utils.config import ConfigOptions
from asr_decoder_tpu_torch.utils.logging import get_logger, set_verbose_level, vlog
from asr_decoder_tpu_torch.utils.timer import Timer
