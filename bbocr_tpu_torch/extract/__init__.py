from bbocr_tpu_torch.extract.extractor import BookMetadataExtractor
from bbocr_tpu_torch.extract.heuristics import heuristic_extract, heuristic_extract_lines
from bbocr_tpu_torch.extract.prompt import PROMPT_TEMPLATE, build_prompt
from bbocr_tpu_torch.extract.schema import (
    METADATA_SCHEMA,
    SchemaError,
    empty_metadata,
    validate_metadata,
    validate_schema,
)

__all__ = [
    "BookMetadataExtractor",
    "METADATA_SCHEMA",
    "PROMPT_TEMPLATE",
    "SchemaError",
    "build_prompt",
    "empty_metadata",
    "heuristic_extract",
    "heuristic_extract_lines",
    "validate_metadata",
    "validate_schema",
]
