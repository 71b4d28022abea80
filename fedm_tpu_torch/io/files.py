"""Output-path management: the `Files` singleton, with the JAX package's
and the reference's contract (`fedm/file_io.py:22-117`):
- `file_input` must exist when assigned;
- `output_folder_path` auto-creates;
- `error_file` -> '<output>/relative error.log', lazily truncated on first
  access per run (re-armed when the output dir changes);
- `model_log`  -> '<output>/model.log', same truncation behaviour.
"""

from __future__ import annotations

from pathlib import Path


def truncate_file(path: Path) -> None:
    """Create/empty `path`, creating parent directories as needed."""
    path = Path(path)
    if not path.parent.exists():
        path.parent.mkdir(parents=True)
    with open(path, "w"):
        pass


class Files:
    def __init__(self):
        self._input_dir = Path.cwd() / "file_input"
        self._output_dir = Path.cwd() / "output"
        self._error_file_accessed = False
        self._model_log_accessed = False

    @property
    def file_input(self) -> Path:
        return self._input_dir

    @file_input.setter
    def file_input(self, value) -> None:
        value = Path(value)
        if not value.is_dir():
            raise RuntimeError(
                f"files.file_input: '{value}' is not a directory")
        self._input_dir = value

    @property
    def output_folder_path(self) -> Path:
        return self._output_dir

    @output_folder_path.setter
    def output_folder_path(self, value) -> None:
        value = Path(value)
        if value.resolve() != self._output_dir.resolve():
            self._error_file_accessed = False
            self._model_log_accessed = False
        if not value.is_dir():
            value.mkdir(parents=True)
        self._output_dir = value

    @property
    def error_file(self) -> Path:
        result = self.output_folder_path / "relative error.log"
        if not self._error_file_accessed:
            truncate_file(result)
            self._error_file_accessed = True
        return result

    @property
    def model_log(self) -> Path:
        result = self.output_folder_path / "model.log"
        if not self._model_log_accessed:
            truncate_file(result)
            self._model_log_accessed = True
        return result


files = Files()
