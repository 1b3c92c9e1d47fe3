from .mcep_vocoder import MelCepstralVocoder
from .world_vocoder import WorldVocoder
