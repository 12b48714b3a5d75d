from .data_collator import (
    DataCollatorForLanguageModeling,
    DataCollatorWithPadding,
    default_data_collator,
)
