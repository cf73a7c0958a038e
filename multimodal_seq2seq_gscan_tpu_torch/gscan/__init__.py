from multimodal_seq2seq_gscan_tpu_torch.gscan.types import (
    Position, Object, PositionedObject, Situation, Direction,
    NORTH, SOUTH, EAST, WEST, DIR_TO_INT, INT_TO_DIR, DIR_STR_TO_DIR, DIR_VEC_TO_DIR,
    Term, LogicalForm, Variable, Weights, SemType, ENTITY, COLOR, SIZE, EVENT,
    topo_sort,
)
from multimodal_seq2seq_gscan_tpu_torch.gscan.object_vocabulary import ObjectVocabulary
from multimodal_seq2seq_gscan_tpu_torch.gscan.vocabulary import Vocabulary
from multimodal_seq2seq_gscan_tpu_torch.gscan.world import World
from multimodal_seq2seq_gscan_tpu_torch.gscan.grammar import Grammar, Derivation
from multimodal_seq2seq_gscan_tpu_torch.gscan.dataset import GroundedScan
from multimodal_seq2seq_gscan_tpu_torch.gscan.encode import (
    encode_situation_from_representation, num_grid_channels,
)
